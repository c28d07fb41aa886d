"""CLI argument system: dataclass-driven argparse (port of
``layerskip_tpu/cli/args.py``).

The same flag names and defaults as the JAX package, on stdlib argparse, so
the CLI needs no transformers. ``Arguments.device`` picks the torch device
(the JAX package picks its platform with ``LAYERSKIP_PLATFORM``).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, Optional, Sequence, Type


@dataclasses.dataclass
class Arguments:
    """The JAX package's ``Arguments`` and the device to run on."""

    model: str
    model_args: Optional[str] = None  # "dtype=float32": a checkpoint's dtype
    seed: int = 42
    output_dir: str = "./logs"
    dp: int = 1  # data-parallel mesh axis (batch rows; run dp*tp ranks)
    tp: int = 1  # tensor-parallel mesh axis (heads, features, vocab)
    quantize: str = "none"  # weight-only quantization: none | int8 | int4
    device: str = "cuda"  # "cpu" runs the kernels' plain versions


def handle_arg_string(arg: str) -> Any:
    """Type-coerce a k=v string value."""
    if arg.lower() == "true":
        return True
    if arg.lower() == "false":
        return False
    if arg.isnumeric():
        return int(arg)
    try:
        return float(arg)
    except ValueError:
        return arg


def simple_parse_args_string(args_string: Optional[str]) -> Dict[str, Any]:
    """'k1=v1,k2=v2' -> dict."""
    if not args_string:
        return {}
    args_string = args_string.strip()
    if not args_string:
        return {}
    return {
        k: handle_arg_string(v)
        for k, v in (pair.split("=") for pair in args_string.split(","))
    }


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def add_dataclass_args(parser, dc: Type) -> None:
    """Register one ``--flag`` per dataclass field."""
    for f in dataclasses.fields(dc):
        tp = _unwrap_optional(f.type if not isinstance(f.type, str) else eval(f.type))  # noqa: S307
        flag = "--" + f.name
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        else:
            default = None
        required = default is None and f.default is dataclasses.MISSING and (
            f.default_factory is dataclasses.MISSING  # type: ignore[misc]
        )
        if tp is bool:
            parser.add_argument(
                flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default, required=required,
            )
        elif typing.get_origin(tp) in (list, typing.List) or tp in (list, List):
            parser.add_argument(flag, nargs="*", default=default, required=required)
        elif tp in (int, float, str):
            parser.add_argument(flag, type=tp, default=default, required=required)
        else:
            parser.add_argument(flag, type=str, default=default, required=required)


def parse_dataclasses(dcs: Sequence[Type], argv: Optional[List[str]] = None):
    """Parse argv into instances of the given dataclasses (one flat flag
    namespace, each dataclass taking the fields it declares)."""
    import argparse

    parser = argparse.ArgumentParser()
    for dc in dcs:
        add_dataclass_args(parser, dc)
    ns = parser.parse_args(argv)
    out = []
    for dc in dcs:
        kwargs = {
            f.name: getattr(ns, f.name)
            for f in dataclasses.fields(dc)
            if hasattr(ns, f.name)
        }
        out.append(dc(**kwargs))
    return tuple(out)
