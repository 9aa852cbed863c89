"""Regex-based name resolution.

PyTorch-package copy of mjlab_tpu/utils/string.py (no JAX in it, but the
port imports nothing of the JAX package): resolve ordered regex
expressions against name lists, giving the static index lists the runtime
bakes into its gathers at startup.
"""

from __future__ import annotations

import re
from typing import Sequence


def resolve_matching_names(
    keys: str | Sequence[str],
    names: Sequence[str],
    preserve_order: bool = False,
) -> tuple[list[int], list[str]]:
    """Match regex key(s) against names: (ids, matched names), in
    ``names`` order, or in the keys' order with preserve_order. Every key
    must match at least one name."""
    if isinstance(keys, str):
        keys = [keys]
    compiled = [re.compile(k) for k in keys]

    ids: list[int] = []
    matched: list[str] = []
    used_keys = [False] * len(keys)
    if not preserve_order:
        for i, n in enumerate(names):
            for ki, c in enumerate(compiled):
                if c.fullmatch(n):
                    ids.append(i)
                    matched.append(n)
                    used_keys[ki] = True
                    break
    else:
        for ki, c in enumerate(compiled):
            for i, n in enumerate(names):
                if c.fullmatch(n) and i not in ids:
                    ids.append(i)
                    matched.append(n)
                    used_keys[ki] = True
    if not all(used_keys):
        unused = [k for k, u in zip(keys, used_keys) if not u]
        raise ValueError(
            f"No names matched for expressions {unused}; available: {list(names)}"
        )
    return ids, matched


def resolve_matching_names_values(
    data: dict[str, object],
    names: Sequence[str],
) -> tuple[list[int], list[str], list[object]]:
    """Resolve a dict of regex -> value against names: (ids, matched
    names, values) in ``names`` order. A name matched by two keys, or a
    key that matches no name, raises."""
    ids: list[int] = []
    matched: list[str] = []
    values: list[object] = []
    used_keys = set()
    for i, n in enumerate(names):
        hit = None
        for k in data:
            if re.fullmatch(k, n):
                if hit is not None:
                    raise ValueError(
                        f"Name '{n}' matched by multiple expressions: '{hit}' and '{k}'"
                    )
                hit = k
        if hit is not None:
            ids.append(i)
            matched.append(n)
            values.append(data[hit])
            used_keys.add(hit)
    unused = set(data) - used_keys
    if unused:
        raise ValueError(
            f"No names matched for expressions {sorted(unused)}; available: {list(names)}"
        )
    return ids, matched, values
