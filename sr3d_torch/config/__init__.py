"""Config system: the attribute tree, its defaults (same schema as the
JAX package, so the repo's ``configs/*.yml`` load unchanged) and the
package-level entry ``load_config`` / ``parse_args``, whose flags are the
JAX package's: ``-c/--config``, ``-p/--phase``, ``-s/--sample``,
``-ckt/--checkpoint``, ``-m/--model`` and dotted ``key value`` overrides.
"""

from __future__ import annotations

import argparse
import os

from .defaults import get_cfg_defaults, update_cfg
from .node import ConfigNode

__all__ = [
    "ConfigNode",
    "get_cfg_defaults",
    "update_cfg",
    "parse_args",
    "load_config",
]


def load_config(
    config_file: str | None = None,
    phase: str | None = None,
    sample: int | None = None,
    checkpoint: str | None = None,
    model: str | None = None,
    overrides: list | None = None,
) -> ConfigNode:
    """Defaults ← ``config_file`` ← the named fields ← ``overrides``
    (``["a.b", value, ...]``); ``output_dir`` becomes
    ``{output_dir}/{name}``."""
    cfg = get_cfg_defaults()
    if config_file is not None:
        cfg = update_cfg(cfg, config_file)
        cfg.cfg_file = config_file
    if phase is not None:
        cfg.phase = phase
    if sample is not None:
        cfg.sample = sample
    if checkpoint is not None:
        cfg.checkpoint = checkpoint
    if model is not None:
        cfg.model = model
    if overrides:
        cfg.merge_from_list(overrides)
    cfg.output_dir = os.path.join(cfg.output_dir, cfg.name)
    return cfg


def parse_args(argv: list[str] | None = None) -> ConfigNode:
    parser = argparse.ArgumentParser(description="sr3d_torch")
    parser.add_argument("-c", "--config", type=str, default=None,
                        help="YAML config file")
    parser.add_argument("-p", "--phase", type=str, choices=["train", "val"],
                        default="train")
    parser.add_argument("-s", "--sample", type=int, default=1)
    parser.add_argument("-ckt", "--checkpoint", type=str, default=None)
    parser.add_argument("-m", "--model", type=str, default="model3")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="dotted key/value override pairs")
    args = parser.parse_args(argv)
    return load_config(
        config_file=args.config,
        phase=args.phase,
        sample=args.sample,
        checkpoint=args.checkpoint,
        model=args.model,
        overrides=args.opts,
    )
