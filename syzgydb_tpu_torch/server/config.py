"""Config system.

Parity with the reference config stack (settings.go:6-40 + cmd/config.go:32-90)
and with the JAX package's ``server/config.py``: the same keys and defaults,
the same layering (defaults < YAML config file at ./syzgy.conf or
/etc/syzgy.conf < environment variables < CLI flags), the same dash ->
underscore flag normalization, and the random_seed field doubling as the
global determinism switch (settings.go:42-78).

``yaml`` is imported only when a config file exists, so a host without
PyYAML runs the server on defaults, environment variables and flags.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ..utils.rng import my_random

DEFAULTS = {
    "syzgy_host": "0.0.0.0:8080",
    "ollama_server": "127.0.0.1:11434",
    "text_model": "all-minilm",
    "image_model": "minicpm-v",
    "data_folder": "./data",
    "html_root": "./html",
    "random_seed": 0,
    # "ollama" = remote HTTP embedding (reference behavior); "device" =
    # the on-device text embedder (models/embedder.py) on the server's
    # device, from embedder_checkpoint when set, else random weights.
    "embedder": "ollama",
    "embedder_checkpoint": "",
    # "auto" = shard every collection over all visible CUDA devices (a
    # data-axis mesh, Collection.use_mesh); "off" = single device.  Auto is
    # a no-op on fewer than two devices.
    "use_mesh": "off",
    # max coalescing window (ms) for concurrent REST searches — one batched
    # device dispatch answers the whole group. A lone query dispatches after
    # ~6ms; once any follower joins the leader waits the full window
    # (server/batcher.py two-phase policy); 0 disables batching
    "search_batch_ms": 16.0,
}


@dataclasses.dataclass
class Config:
    ollama_server: str = DEFAULTS["ollama_server"]
    text_model: str = DEFAULTS["text_model"]
    image_model: str = DEFAULTS["image_model"]
    data_folder: str = DEFAULTS["data_folder"]
    syzgy_host: str = DEFAULTS["syzgy_host"]
    html_root: str = DEFAULTS["html_root"]
    random_seed: int = 0
    embedder: str = "ollama"
    embedder_checkpoint: str = ""
    use_mesh: str = "off"
    search_batch_ms: float = 16.0


global_config = Config()


def configure(cfg: Config) -> None:
    """Install the global config; a non-zero random_seed makes the whole DB
    deterministic (settings.go:33-40)."""
    global global_config
    global_config = cfg
    my_random.seed(cfg.random_seed)


def _read_config_file(path: str) -> dict:
    try:
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        return data if isinstance(data, dict) else {}
    except FileNotFoundError:
        return {}


def load_config(argv: Optional[list[str]] = None,
                config_file: Optional[str] = None) -> Config:
    """Layered load: defaults < config file < env vars < flags."""
    merged = dict(DEFAULTS)

    # config file: explicit path, else ./syzgy.conf then /etc/syzgy.conf
    candidates = [config_file] if config_file else ["./syzgy.conf",
                                                    "/etc/syzgy.conf"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            merged.update({k.replace("-", "_"): v
                           for k, v in _read_config_file(cand).items()})
            break

    # environment variables (upper or lower case, dashes normalized)
    for key in DEFAULTS:
        for env_key in (key.upper(), key):
            if env_key in os.environ:
                merged[key] = os.environ[env_key]
                break

    # CLI flags --key value / --key=value with -/_ normalization
    if argv:
        i = 0
        while i < len(argv):
            arg = argv[i]
            if arg.startswith("--"):
                body = arg[2:]
                if "=" in body:
                    key, val = body.split("=", 1)
                else:
                    key = body
                    if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                        i += 1
                        val = argv[i]
                    else:
                        val = "true"
                key = key.replace("-", "_")
                if key in DEFAULTS:
                    merged[key] = val
            i += 1

    cfg = Config(
        ollama_server=str(merged["ollama_server"]),
        text_model=str(merged["text_model"]),
        image_model=str(merged["image_model"]),
        data_folder=str(merged["data_folder"]),
        syzgy_host=str(merged["syzgy_host"]),
        html_root=str(merged["html_root"]),
        random_seed=int(merged["random_seed"]),
        embedder=str(merged["embedder"]),
        embedder_checkpoint=str(merged["embedder_checkpoint"]),
        use_mesh=str(merged["use_mesh"]),
        search_batch_ms=float(merged["search_batch_ms"]),
    )
    os.makedirs(cfg.data_folder, exist_ok=True)
    return cfg
