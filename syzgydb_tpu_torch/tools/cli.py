"""CLI entry point of the port (reference: cmd/main.go; the JAX package's
``syzgydb_tpu/tools/cli.py``):

    python -m syzgydb_tpu_torch.tools.cli --serve [--platform cuda|cpu]

--serve loads the config (defaults < syzgy.conf < environment < flags) and
runs the REST server on the device --platform names: CUDA by default, which
raises at start-up on a host without a card, or the CPU.  --no-profiler is
accepted for parity and changes nothing: the port starts no trace server.
--dump, --export, --import and --import-ref parse as in the JAX package and
raise NotImplementedError: the tools are the next slice of the port.
"""

from __future__ import annotations

import argparse
import logging
import sys

_TOOLS_NOT_PORTED = ("{} is not ported yet (ROADMAP.md Queue 1, item 2: "
                     "Tools and envelope)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="syzgy-torch",
        description="SyzgyDB-compatible vector database on PyTorch/CUDA")
    p.add_argument("--serve", action="store_true", help="run the REST server")
    p.add_argument("--dump", metavar="FILE", help="dump a collection file")
    p.add_argument("--export", metavar="FILE",
                   help="export a collection file as JSON to stdout")
    p.add_argument("--import", dest="import_file", metavar="FILE",
                   help="import a JSON export")
    p.add_argument("--import-ref", dest="import_ref", metavar="FILE",
                   help="import a reference SyzgyDB .dat span file")
    p.add_argument("--output", metavar="FILE",
                   help="output collection file for --import/--import-ref")
    p.add_argument("--compact", action="store_true",
                   help="with --export: write vectors as base64 of the "
                        "packed storage bytes")
    p.add_argument("--config", metavar="FILE", help="config file path")
    # config flags (cmd/config.go:15-22)
    for flag in ("ollama-server", "text-model", "image-model", "data-folder",
                 "syzgy-host", "html-root", "random-seed"):
        p.add_argument(f"--{flag}", dest=flag.replace("-", "_"), default=None)
    p.add_argument("--no-profiler", action="store_true",
                   help="accepted for parity; the port starts no profiler")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="the server's device (default cuda)")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)

    for flag, val in (("--dump", args.dump), ("--export", args.export),
                      ("--import", args.import_file),
                      ("--import-ref", args.import_ref)):
        if val:
            raise NotImplementedError(_TOOLS_NOT_PORTED.format(flag))

    from ..server import config as cfg_mod
    flag_argv = []
    for key in cfg_mod.DEFAULTS:
        val = getattr(args, key, None)
        if val is not None:
            flag_argv += [f"--{key}", str(val)]
    cfg = cfg_mod.load_config(flag_argv, config_file=args.config)
    cfg_mod.configure(cfg)

    if args.serve:
        from ..core.collection import resolve_device
        from ..server.rest import make_server, run_server
        from ..utils.hostmem import tune_host_allocator
        # resolved before anything is loaded: --platform cuda on a host
        # without a card raises here
        device = resolve_device(args.platform)
        tune_host_allocator()
        run_server(make_server(device=device))
        return 0

    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
