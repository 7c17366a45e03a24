"""CLI entry point of the port (reference: cmd/main.go; the JAX package's
``syzgydb_tpu/tools/cli.py``), installed as ``syzgy-torch``:

    python -m syzgydb_tpu_torch.tools.cli --serve [--platform cuda|cpu]
    python -m syzgydb_tpu_torch.tools.cli --dump FILE
    python -m syzgydb_tpu_torch.tools.cli --export FILE [--compact] > out.json
    python -m syzgydb_tpu_torch.tools.cli --import out.json --output FILE \
        [--platform cuda|cpu]
    python -m syzgydb_tpu_torch.tools.cli --import-ref ref.dat --output FILE \
        [--platform cuda|cpu]

--serve loads the config (defaults < syzgy.conf < environment < flags) and
runs the REST server on the device --platform names: CUDA by default, which
raises at start-up on a host without a card, or the CPU.  --import and
--import-ref (a SyzgyDB Go .dat span file) write a new collection file,
--output, opened on that device in the same way: each batch of records
passes the capacity preflight before it is written.  --dump prints the
records of a collection file from its bytes, and --export writes the
collection as JSON to stdout (--compact: base64 of the packed storage
bytes); both read only the file and launch no kernel, so they need no
card.  chip_smoke.py's tools phase drives the same functions on the card
(export_json, import_json, import_ref_file, dump_index).  --no-profiler
is accepted for parity and changes nothing: the port starts no trace
server.
"""

from __future__ import annotations

import argparse
import logging
import sys


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
                   help="the device of --serve, --import and --import-ref "
                        "(default cuda)")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)

    from ..server import config as cfg_mod
    flag_argv = []
    for key in cfg_mod.DEFAULTS:
        val = getattr(args, key, None)
        if val is not None:
            flag_argv += [f"--{key}", str(val)]
    cfg = cfg_mod.load_config(flag_argv, config_file=args.config)
    cfg_mod.configure(cfg)

    if args.dump:
        from .dump import dump_index
        dump_index(args.dump)
        return 0

    if args.export:
        from ..core.collection import Collection, CollectionOptions
        from .dump import export_json
        # the export reads the span log alone: the collection is opened on
        # the CPU, whatever --platform says
        coll = Collection(CollectionOptions(name=args.export,
                                            dimension_count=1), device="cpu")
        try:
            export_json(coll, sys.stdout, compact=args.compact)
        finally:
            coll.close()
        return 0

    if args.import_file:
        if not args.output:
            print("--import requires --output", file=sys.stderr)
            return 2
        from ..core.collection import resolve_device
        from .dump import import_json
        # resolved before the input is read: --platform cuda on a host
        # without a card raises here
        device = resolve_device(args.platform)
        with open(args.import_file) as f:
            coll = import_json(args.output, f, device=device)
        coll.close()
        print(f"Imported into {args.output}")
        return 0

    if args.import_ref:
        if not args.output:
            print("--import-ref requires --output", file=sys.stderr)
            return 2
        from ..core.collection import resolve_device
        from .refimport import import_ref_file
        device = resolve_device(args.platform)
        coll = import_ref_file(args.import_ref, args.output, device=device)
        n = coll.get_document_count()
        coll.close()
        print(f"Imported {n} records from reference file into {args.output}")
        return 0

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
