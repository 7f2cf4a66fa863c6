"""A copy of ``eventful_transformer_tpu/utils/config.py`` for the port: it
reads the repo's ``configs/`` as they are.

Config system: YAML with recursive ``_defaults`` composition, CLI dotlist
overrides and ``${...}`` interpolation.

Reimplements the reference's OmegaConf-based system (utils/config.py:7-56)
on plain PyYAML (OmegaConf is not available in this environment):

  * ``_defaults``: list of config paths (relative to the file or to the repo
    root), merged in order with later-wins semantics, current file last.
  * CLI: ``<script> <config-name> [a.b.c=value ...]``.
  * ``${key.path}`` interpolation resolved against the merged config.
  * ``_name`` auto-generated from the config stem + overrides.
  * ``initialize_run`` snapshots the resolved config into ``_output``.
"""

from __future__ import annotations

import re
from argparse import ArgumentParser
from pathlib import Path

import yaml

_INTERP = re.compile(r"\$\{([^}]+)\}")


def _merge(base, override):
    """Recursive dict merge, later-wins (OmegaConf.merge semantics)."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for key, value in override.items():
            out[key] = _merge(base[key], value) if key in base else value
        return out
    return override


def _lookup(config, dotted):
    node = config
    for part in dotted.split("."):
        node = node[part]
    return node


def _interpolate(node, root):
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str) and "${" in node:
        def sub(match):
            try:
                return str(_lookup(root, match.group(1)))
            except (KeyError, TypeError):
                return match.group(0)  # leave unresolvable refs in place

        full = _INTERP.fullmatch(node)
        if full:  # a lone ${...} preserves the referenced type
            try:
                return _lookup(root, full.group(1))
            except (KeyError, TypeError):
                return node
        return _INTERP.sub(sub, node)
    return node


def load_config(config_path, resolve=True, root=None):
    """Load a YAML config, composing ``_defaults`` recursively
    (reference utils/config.py:47-56). ``_defaults`` paths resolve relative
    to the config file first, then to ``root`` (default: CWD, matching the
    reference's run-from-repo-root convention)."""
    config_path = Path(config_path)
    with open(config_path) as f:
        config = yaml.safe_load(f) or {}
    merged = {}
    for defaults_path in config.pop("_defaults", []):
        relative = config_path.parent / defaults_path
        chosen = relative if relative.is_file() else Path(root or ".") / defaults_path
        merged = _merge(merged, load_config(chosen, resolve=False, root=root))
    merged = _merge(merged, config)
    return _interpolate(merged, merged) if resolve else merged


def parse_dotlist(overrides):
    """Parse ``a.b.c=value`` overrides (values parsed as YAML)."""
    config = {}
    for item in overrides:
        key, _, raw = item.partition("=")
        value = yaml.safe_load(raw) if raw != "" else None
        node = config
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return config


def get_cli_config(config_location=".", argv=None):
    """CLI entry: config name + dotlist overrides
    (reference utils/config.py:7-32)."""
    parser = ArgumentParser()
    parser.add_argument(
        "name",
        help=f'the configuration name (the file is "{config_location}/<name>.yml")',
    )
    parser.add_argument(
        "overrides", nargs="*", help="configuration overrides (like a.b.c=value)"
    )
    args = parser.parse_args(argv)
    config_path = Path(config_location, f"{args.name}.yml")
    config = load_config(config_path, resolve=False)
    config = _merge(config, parse_dotlist(args.overrides))
    if "_name" not in config:
        if len(args.overrides) == 0:
            name = config_path.stem
        else:
            name = f"{config_path.stem}-{'-'.join(args.overrides)}"
        if len(name) > 120:  # keep run names filesystem-safe
            import hashlib

            digest = hashlib.sha1(name.encode()).hexdigest()[:10]
            name = f"{name[:100]}-{digest}"
        config["_name"] = name
    return _interpolate(config, config)


def initialize_run(config_location=".", argv=None):
    """CLI config + output-directory setup + resolved-config snapshot
    (reference utils/config.py:35-44)."""
    return save_run_config(get_cli_config(config_location=config_location, argv=argv))


def save_run_config(config):
    """Write ``config`` to ``<_output>/config.yml`` (where it names an
    output directory) and return it."""
    if "_output" in config:
        output_dir = Path(config["_output"])
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / "config.yml", "w") as f:
            yaml.safe_dump(config, f, sort_keys=False)
    return config
