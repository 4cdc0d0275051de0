"""Argparse derivation from ``CoexecSpec`` fields.

The serve CLI's co-execution flags are *derived* from the spec
dataclasses: each sub-spec field carries its flag name/help/choices in
dataclass field metadata (see ``_cli`` in :mod:`repro_torch.api.spec`),
and

* :func:`add_spec_args` walks those fields and adds one argparse flag
  per field — a new spec field becomes a new CLI flag everywhere, free;
* :func:`spec_from_args` folds a parsed namespace back into a
  :class:`~repro_torch.api.spec.CoexecSpec`;
* :func:`args_from_spec` emits the minimal argv that reproduces a spec,
  so CLI-args → spec → CLI-args is a round trip (pinned by tests).

Tuple fields parse as comma lists (``--dist 0.4,0.6``); policy-specific
scheduler options ride a repeatable ``--scheduler-opt key=value`` flag
whose values are JSON-decoded (``--scheduler-opt num_packages=8``). The
literal ``none`` resets an Optional field (``--max-inflight none``) or
clears accumulated options (``--scheduler-opt none``), so every spec is
reachable from argv even over a non-default base.

:func:`registry_listing` lists schedulers, workloads and kernels. The
reference's listing adds an ``analysis:`` section of its static-analysis
passes; the port has no analysis package yet, so that section is left out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Any, Optional, Sequence

from .spec import CoexecSpec

__all__ = ["SPEC_SECTIONS", "add_spec_args", "spec_from_args",
           "args_from_spec", "registry_listing"]

# section order fixes flag ordering in --help and in args_from_spec output
SPEC_SECTIONS = ("scheduler", "admission", "workload", "units", "memory",
                 "traffic", "cluster")


def _section_class(section: str) -> type:
    field = {f.name: f for f in dataclasses.fields(CoexecSpec)}[section]
    return field.default_factory  # every section has a dataclass factory


def _cli_fields(sections: Sequence[str]):
    """Yield ``(section, field, resolved_type)`` for every CLI field."""
    for section in sections:
        cls = _section_class(section)
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if "cli" not in f.metadata:
                continue
            yield section, f, hints[f.name]


def _scalar_type(tp) -> Optional[type]:
    """The concrete scalar parser for a field type (None = not scalar)."""
    if tp in (int, float, str):
        return tp
    origin = typing.get_origin(tp)
    if origin is typing.Union:           # Optional[int] and friends
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1 and args[0] in (int, float, str):
            return args[0]
    return None


def _is_optional(tp) -> bool:
    """Whether the field type admits ``None`` (``Optional[...]``)."""
    return (typing.get_origin(tp) is typing.Union
            and type(None) in typing.get_args(tp))


class _OptionalScalar:
    """Argparse ``type=`` for Optional fields: the literal ``none`` resets.

    Makes every value of an Optional spec field expressible on the
    command line (``--max-inflight none`` clears a base spec's cap), so
    ``args_from_spec`` stays a true inverse of ``spec_from_args`` even
    over a non-default base. Parsed ``None`` is carried as a sentinel —
    argparse's "flag not given" is already plain ``None``.
    """

    RESET = "\0reset"    # sentinel: flag given, value is None

    def __init__(self, elem: type):
        self.elem = elem
        self.__name__ = elem.__name__    # argparse error messages

    def __call__(self, raw: str):
        if raw.lower() in ("none", ""):
            return self.RESET
        return self.elem(raw)


def _tuple_elem(tp) -> Optional[type]:
    """Element parser for ``tuple[elem, ...]`` fields (None otherwise)."""
    if typing.get_origin(tp) is tuple:
        args = typing.get_args(tp)
        if args and args[0] in (int, float, str):
            return args[0]
    return None


def _parse_kv(item: str) -> Optional[tuple[str, Any]]:
    """Parse one ``key=value`` option; value is JSON, else a raw string.

    The literal ``none`` (no ``=``) clears previously accumulated
    options — the kv analogue of ``--max-inflight none``.
    """
    if item.lower() == "none":
        return None
    key, sep, raw = item.partition("=")
    if not sep or not key:
        raise argparse.ArgumentTypeError(
            f"expected key=value (or the literal none), got {item!r}")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return key, value


def add_spec_args(parser: argparse.ArgumentParser, *,
                  sections: Sequence[str] = SPEC_SECTIONS) -> None:
    """Add one flag per spec field to ``parser``.

    Every flag defaults to ``None`` (= "not given"): only flags the user
    actually passed override the base spec in :func:`spec_from_args`, so
    the same parser serves different base specs.

    Args:
        parser: the argparse parser to extend.
        sections: which ``CoexecSpec`` sections to derive flags for.
    """
    for section, f, tp in _cli_fields(sections):
        flag = "--" + f.metadata["cli"]
        help_ = f.metadata.get("help", "")
        choices = f.metadata.get("choices")
        if f.metadata.get("kv"):
            parser.add_argument(flag, action="append", default=None,
                                type=_parse_kv, metavar="KEY=VALUE",
                                help=help_)
        elif tp is bool:
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=None, help=help_)
        elif _tuple_elem(tp) is not None:
            parser.add_argument(flag, default=None, metavar="V[,V...]",
                                help=help_)
        else:
            scalar = _scalar_type(tp) or str
            if _is_optional(tp):
                scalar = _OptionalScalar(scalar)
            parser.add_argument(flag, type=scalar, default=None,
                                choices=choices, help=help_)


def _dest(f: dataclasses.Field) -> str:
    return f.metadata["cli"].replace("-", "_")


def spec_from_args(args: argparse.Namespace, *,
                   base: Optional[CoexecSpec] = None,
                   sections: Sequence[str] = SPEC_SECTIONS) -> CoexecSpec:
    """Fold a parsed namespace into a spec (unset flags keep the base).

    Args:
        args: namespace from a parser built with :func:`add_spec_args`.
        base: spec supplying values for flags the user did not pass.
        sections: sections to read (must match ``add_spec_args``).

    Returns:
        The merged :class:`CoexecSpec`.
    """
    spec = base if base is not None else CoexecSpec()
    for section, f, tp in _cli_fields(sections):
        value = getattr(args, _dest(f), None)
        if value is None:
            continue
        if f.metadata.get("kv"):
            # a literal `none` item clears everything accumulated so far
            pairs: list = []
            for item in value:
                pairs = [] if item is None else pairs + [item]
            value = tuple(pairs)
        elif _tuple_elem(tp) is not None:
            elem = _tuple_elem(tp)
            value = tuple(elem(v) for v in str(value).split(",") if v != "")
        elif value == _OptionalScalar.RESET:
            value = None
        sub = getattr(spec, section).replace(**{f.name: value})
        spec = spec.replace(**{section: sub})
    return spec


def registry_listing() -> str:
    """Human-readable dump of every registered plugin (``--list``).

    One line per registered scheduler, workload and kernel with its
    declared option fields — the introspection surface the serve CLI
    prints, so a freshly registered third-party plugin is discoverable
    without reading code. Kernels additionally show their per-argument
    partition semantics (split axis/halo, broadcast, defaults). There is
    no ``analysis:`` section: the port has no static-analysis passes yet.

    Returns:
        The formatted multi-line listing.
    """
    from . import registry

    lines = ["schedulers:"]
    for name in registry.scheduler_names():
        plugin, _ = registry.resolve_scheduler(name)
        extra = "  [takes a speeds hint]" if plugin.speed_hint else ""
        lines.append(f"  {name:14s} options: "
                     f"{', '.join(sorted(plugin.fields)) or '-'}{extra}")
    lines.append("workloads:")
    for name in registry.workload_names():
        fields = registry.workload_plugin(name).fields
        lines.append(f"  {name:14s} options: "
                     f"{', '.join(sorted(fields)) or '-'}")
    lines.append("kernels:")
    for name in registry.kernel_names():
        plugin = registry.kernel_plugin(name)
        try:
            kernel = plugin.factory()
            args = []
            for a in kernel.args:
                if a.role.value == "split":
                    halo = f"+halo{a.halo}" if a.halo else ""
                    axis = f"@axis{a.axis}" if a.axis else ""
                    args.append(f"{a.name}[split{axis}{halo}]")
                else:
                    dflt = "=default" if a.default is not None else ""
                    args.append(f"{a.name}[broadcast{dflt}]")
            args_desc = ", ".join(args)
        except (TypeError, ValueError, KeyError):
            # a factory with required options cannot be probed for its
            # argument semantics; still list the kernel itself
            args_desc = "(factory needs options)"
        lines.append(f"  {name:14s} args: {args_desc}; options: "
                     f"{', '.join(sorted(plugin.fields)) or '-'}")
    return "\n".join(lines)


def _format_kv(key: str, value: Any) -> str:
    if isinstance(value, tuple):
        value = list(value)
    return f"{key}={json.dumps(value)}"


def args_from_spec(spec: CoexecSpec, *,
                   base: Optional[CoexecSpec] = None,
                   sections: Sequence[str] = SPEC_SECTIONS) -> list[str]:
    """The minimal argv reproducing ``spec`` over ``base``.

    The inverse of :func:`spec_from_args`:
    ``spec_from_args(parse(args_from_spec(s)), base=base) == s`` for any
    spec expressible through the derived flags.

    Args:
        spec: the spec to serialize to CLI tokens.
        base: baseline whose values need no flags (default: all-default).
        sections: sections to emit (must match the parser).

    Returns:
        Flat argv token list (``["--policy", "hguided", ...]``).
    """
    base = base if base is not None else CoexecSpec()
    argv: list[str] = []
    for section, f, tp in _cli_fields(sections):
        value = getattr(getattr(spec, section), f.name)
        if value == getattr(getattr(base, section), f.name):
            continue
        flag = "--" + f.metadata["cli"]
        if f.metadata.get("kv"):
            if not value:               # clear a base spec's options
                argv += [flag, "none"]
            for key, v in value:
                argv += [flag, _format_kv(key, v)]
        elif tp is bool:
            argv.append(flag if value else "--no-" + f.metadata["cli"])
        elif _tuple_elem(tp) is not None:
            argv += [flag, ",".join(str(v) for v in value)]
        else:
            argv += [flag, str(value)]
    return argv
