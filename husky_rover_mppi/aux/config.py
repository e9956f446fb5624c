"""Configuration system: YAML + dotted overrides -> registered dataclasses.

Replaces the reference's Hydra/OmegaConf pipeline (run.py:30-73
``omegaconfToDict`` + ``instantiateConfigs`` + configFactory and the
``src/configurations/*`` dataclasses): a plain-YAML tree is composed with
``key=value`` dot-list overrides (the Hydra CLI syntax documented in
wiki/modes/Modes.md) and instantiated into the framework's validating
dataclasses through a name registry.

The YAML files are read by :func:`load_yaml`, a reader for the subset the
``cfg/`` tree uses (block maps and lists, flow maps and lists that may span
lines, quoted and plain scalars resolved as YAML 1.1 does, comments), so
the framework needs no YAML package.
"""

from __future__ import annotations

import dataclasses
import math
import re
import typing
from pathlib import Path

# YAML 1.1 plain-scalar resolution, as PyYAML's safe loader applies it
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")


def _scalar(text: str):
    """Resolve one plain or quoted scalar."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        return body.encode("latin-1", "backslashreplace").decode(
            "unicode_escape")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if m := _INF.fullmatch(text):
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    return text


def _outside_quotes(text: str):
    """Yield (index, char, depth) for characters outside quoted scalars,
    with the flow-bracket depth before the character."""
    quote, depth = None, 0
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        else:
            yield i, c, depth
            depth += (c in "[{") - (c in "]}")


def _strip_comment(line: str) -> str:
    for i, c, _ in _outside_quotes(line):
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow_depth(text: str) -> int:
    depth = 0
    for _, c, d in _outside_quotes(text):
        depth = d + (c in "[{") - (c in "]}")
    return depth


def _key_split(text: str):
    """``key: value`` -> (key, value) at the first mapping colon outside
    quotes and flow brackets, or None."""
    for i, c, depth in _outside_quotes(text):
        if c == ":" and depth == 0 and (i + 1 == len(text)
                                        or text[i + 1] in " \t"):
            return _scalar(text[:i].strip()), text[i + 1:].strip()
    return None


def _flow(text: str, pos: int = 0):
    """Parse a flow collection or scalar starting at ``pos``; returns
    (value, end position)."""
    while text[pos] == " ":
        pos += 1
    if text[pos] in "[{":
        close = "]" if text[pos] == "[" else "}"
        items = [] if close == "]" else {}
        pos += 1
        while True:
            while text[pos] in " ,":
                pos += 1
            if text[pos] == close:
                return items, pos + 1
            if close == "]":
                value, pos = _flow(text, pos)
                items.append(value)
            else:
                key, pos = _flow(text, pos)
                while text[pos] == " ":
                    pos += 1
                if text[pos] == ":":
                    value, pos = _flow(text, pos + 1)
                else:
                    value = None
                items[key] = value
    if text[pos] in "'\"":
        end = pos + 1
        while text[end] != text[pos] or text[end + 1:end + 2] == text[pos]:
            end += 2 if text[end] == text[pos] else 1
        return _scalar(text[pos:end + 1]), end + 1
    end = pos
    while end < len(text) and text[end] not in ",]}" and not (
            text[end] == ":" and text[end + 1:end + 2] in (" ", "")):
        end += 1
    return _scalar(text[pos:end].strip()), end


def parse_value(text: str):
    """One inline value: a flow collection or a scalar."""
    text = text.strip()
    if text[:1] in ("[", "{"):
        value, end = _flow(text)
        if text[end:].strip():
            raise ValueError(f"trailing text after flow value: {text!r}")
        return value
    return _scalar(text)


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: list, i: int, indent: int):
    """Parse the block node whose first line is ``lines[i]``."""
    if _is_item(lines[i][1]):
        items = []
        while i < len(lines) and lines[i][0] == indent \
                and _is_item(lines[i][1]):
            rest = lines[i][1][1:].strip()
            if not rest:
                value, i = _block(lines, i + 1, lines[i + 1][0])
            elif rest[0] not in "[{'\"" and _key_split(rest) is not None:
                # "- key: value": a map whose first line starts at `rest`
                col = indent + len(lines[i][1]) - len(rest)
                lines[i] = (col, rest)
                value, i = _block(lines, i, col)
            else:
                value, i = parse_value(rest), i + 1
            items.append(value)
        return items, i
    mapping = {}
    while i < len(lines) and lines[i][0] == indent \
            and not _is_item(lines[i][1]):
        split = _key_split(lines[i][1])
        if split is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = split
        i += 1
        if rest:
            mapping[key] = parse_value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            mapping[key] = None
    return mapping, i


def load_yaml(text: str):
    """Parse a YAML document of the subset the ``cfg/`` tree uses."""
    lines = []
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if pending is not None:  # continuation of an open flow collection
            pending = (pending[0], pending[1] + " " + line.strip())
        else:
            pending = (len(line) - len(line.lstrip()), line.strip())
        if _flow_depth(pending[1]) == 0:
            lines.append(pending)
            pending = None
    if pending is not None:
        raise ValueError(f"unclosed flow collection: {pending[1]!r}")
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def dump_yaml(mapping: dict) -> str:
    """Write a flat mapping of scalars and lists of scalars as YAML that
    :func:`load_yaml` (and any YAML 1.1 reader) reads back."""
    def scalar(v):
        if isinstance(v, bool) or v is None:
            return {True: "true", False: "false", None: "null"}[v]
        if isinstance(v, float):
            s = repr(v)
            if "e" in s and "." not in s:  # YAML 1.1 floats need a dot
                s = s.replace("e", ".0e")
            return s
        if isinstance(v, int):
            return str(v)
        return "'" + str(v).replace("'", "''") + "'"

    out = []
    for k, v in mapping.items():
        if isinstance(v, (list, tuple)):
            out.append(f"{k}: [{', '.join(scalar(x) for x in v)}]")
        else:
            out.append(f"{k}: {scalar(v)}")
    return "\n".join(out) + "\n"


class ConfigFactory:
    """Name -> dataclass registry (run.py:56-73 configFactory)."""

    def __init__(self):
        self._registry: dict[str, type] = {}

    def register(self, name: str, cls: type) -> None:
        self._registry[name] = cls

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def instantiate(self, name: str, data: dict):
        if name not in self._registry:
            raise ValueError(f"Unknown configuration: {name}")
        return _build_dataclass(self._registry[name], data)


def _build_dataclass(cls, data):
    """Recursively build a dataclass from a dict, instantiating nested
    dataclass fields (the reference's __post_init__ expansion pattern,
    src/configurations/environments.py:126-290)."""
    if data is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        if hasattr(cls, "_fields"):  # NamedTuple configs (e.g. RoverParams)
            if isinstance(data, dict):
                unknown = set(data) - set(cls._fields)
                if unknown:
                    raise ValueError(
                        f"{cls.__name__}: unknown keys {sorted(unknown)}")
                return cls(**data)
            return data
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for field in dataclasses.fields(cls):
        if field.name not in data:
            continue
        value = data[field.name]
        ftype = hints.get(field.name, field.type)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[field.name] = _build_dataclass(ftype, value)
        elif hasattr(ftype, "_fields") and isinstance(value, dict):
            kwargs[field.name] = ftype(**value)  # NamedTuple configs
        elif isinstance(value, list):
            kwargs[field.name] = tuple(value) if _wants_tuple(ftype) else value
        else:
            kwargs[field.name] = value
    unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
    return cls(**kwargs)


def _wants_tuple(ftype) -> bool:
    origin = typing.get_origin(ftype)
    return ftype in (tuple,) or origin is tuple


def apply_overrides(tree: dict, overrides: list[str]) -> dict:
    """Hydra-style ``a.b.c=value`` dot-list overrides."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, _, raw = item.partition("=")
        value = parse_value(raw)
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def load_config(path: str | Path, overrides: list[str] | None = None) -> dict:
    """Load a YAML tree, resolve ``defaults:`` includes relative to the
    file (single-level Hydra-style composition), apply overrides."""
    path = Path(path)
    tree = load_yaml(path.read_text()) or {}
    defaults = tree.pop("defaults", [])
    merged: dict = {}
    for entry in defaults:
        if isinstance(entry, dict):
            (group, name), = entry.items()
            sub = load_config(path.parent / group / f"{name}.yaml")
            merged[group] = sub
        else:
            sub = load_config(path.parent / f"{entry}.yaml")
            merged.update(sub)
    merged.update(tree)
    if overrides:
        apply_overrides(merged, overrides)
    return merged


def default_factory() -> ConfigFactory:
    """Factory pre-loaded with the framework's config dataclasses."""
    from ..env.closed_loop import ClosedLoopConfig
    from ..env.rover_sim import RoverParams
    from ..mppi.controller import MPPIConfig
    from ..physics import PhysicsSceneConf
    from ..physics.deformation import DeformationEngineConf
    from ..physics.terramechanics import (
        RobotParameter,
        TerrainMechanicalParameter,
    )
    from ..terrain.craters import CraterSamplerConf
    from ..terrain.rocks import RockDistConf
    from ..terrain.streaming import StreamerConf
    from .stellar import StellarEngineConf

    factory = ConfigFactory()
    factory.register("mppi", MPPIConfig)
    factory.register("closed_loop", ClosedLoopConfig)
    factory.register("rover", RoverParams)
    factory.register("physics_scene", PhysicsSceneConf)
    factory.register("deformation_engine", DeformationEngineConf)
    factory.register("terramechanics_robot", RobotParameter)
    factory.register("terramechanics_terrain", TerrainMechanicalParameter)
    factory.register("crater_sampler", CraterSamplerConf)
    factory.register("rock_distribution", RockDistConf)
    factory.register("terrain_streamer", StreamerConf)
    factory.register("stellar_engine", StellarEngineConf)
    return factory


def instantiate_configs(tree: dict, factory: ConfigFactory | None = None) -> dict:
    """Instantiate every top-level key with a registered dataclass;
    unregistered keys pass through as dicts (run.py:56-73 semantics)."""
    factory = factory or default_factory()
    out = {}
    for key, value in tree.items():
        if key in factory and isinstance(value, (dict, type(None))):
            out[key] = factory.instantiate(key, value)
        else:
            out[key] = value
    return out
