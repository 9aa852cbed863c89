"""Filesystem helpers (reference src/mjlab/utils/os.py): YAML config dumps
and regex-latest checkpoint resolution.

PyTorch counterpart of the part of mjlab_tpu/utils/os.py the train CLI
uses. ``dump_yaml`` writes the config dataclasses with a small emitter of
its own, since the card's machine has no PyYAML: block mappings, flow
sequences of scalars, block sequences of mappings, JSON-quoted strings and
floats in the form YAML 1.1 resolves as floats, so that yaml.safe_load
reads back what ``to_plain`` gives.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re


def to_plain(obj):
    """A config tree as dicts, lists and scalars: dataclasses and dicts to
    mappings, tuples to lists, callables to "module.name", tensors and
    arrays to lists, anything else to its str."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    if callable(obj):
        return f"{getattr(obj, '__module__', '')}.{getattr(obj, '__name__', repr(obj))}"
    if hasattr(obj, "tolist"):  # numpy arrays and tensors
        return obj.tolist()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)  # slices, enums, anything else


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mant, _, exp = r.partition("e")
        if "." not in mant:
            mant += ".0"
        if exp and exp[0] not in "+-":
            exp = "+" + exp
        return mant + ("e" + exp if exp else "")
    return json.dumps(str(v))


def _emit(v, indent: int, out: list) -> None:
    pad = "  " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = json.dumps(str(k))
            if isinstance(x, dict) and x:
                out.append(f"{pad}{key}:")
                _emit(x, indent + 1, out)
            elif isinstance(x, list) and any(isinstance(e, (dict, list)) for e in x):
                out.append(f"{pad}{key}:")
                _emit(x, indent + 1, out)
            else:
                out.append(f"{pad}{key}: {_inline(x)}")
    else:  # a list holding mappings or lists
        for x in v:
            if isinstance(x, dict) and x:
                out.append(f"{pad}-")
                _emit(x, indent + 1, out)
            elif isinstance(x, list) and any(isinstance(e, (dict, list)) for e in x):
                out.append(f"{pad}-")
                _emit(x, indent + 1, out)
            else:
                out.append(f"{pad}- {_inline(x)}")


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    return _scalar(v)


def dump_yaml(path: str, data) -> None:
    """Write a (possibly dataclass) config tree as YAML."""
    out: list[str] = []
    plain = to_plain(data)
    if isinstance(plain, (dict, list)) and plain:
        _emit(plain, 0, out)
    else:
        out.append(_inline(plain))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def get_checkpoint_path(
    log_path: str,
    run_dir: str = ".*",
    checkpoint: str = r"model_(\d+).*",
    sort_alpha: bool = True,
) -> str:
    """The newest run dir matching ``run_dir`` (by name, else by mtime) and
    its checkpoint matching ``checkpoint`` with the largest number
    (reference utils/os.py:52-90)."""
    runs = [
        d for d in os.listdir(log_path)
        if re.fullmatch(run_dir, d) and os.path.isdir(os.path.join(log_path, d))
    ]
    if not runs:
        raise FileNotFoundError(f"no run dir matching '{run_dir}' under {log_path}")
    if sort_alpha:
        runs.sort()
    else:
        runs.sort(key=lambda d: os.path.getmtime(os.path.join(log_path, d)))
    run = os.path.join(log_path, runs[-1])
    ckpts = [f for f in os.listdir(run) if re.fullmatch(checkpoint, f)]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint matching '{checkpoint}' in {run}")

    def key(f):
        m = re.search(r"(\d+)", f)
        return int(m.group(1)) if m else -1

    ckpts.sort(key=key)
    return os.path.join(run, ckpts[-1])
