"""Hand-written GPU kernels of the port, their wrappers and plain versions.

``ops`` is the public surface (model-layout entry points); ``ref`` holds the
oracles; ``flash_attention`` the attention wrapper, plain version and tile
chooser; ``mamba2_ssd`` the SSD scan's wrapper and plain version;
``train_attention`` training attention's forward and backward (an autograd
function) and their plain version; ``adamw`` AdamW's update and the global
norm over a tree of leaves and their plain version; ``_build``
compiles ``csrc/*.cu`` at first use.  Importing any of
them compiles nothing.

Each wrapper counts its kernels' launches in attributes of its own (an
integer, or integers by path, plan or kernel).  :data:`COUNTED` lists them,
and :func:`launch_counts`, :func:`launches_since` and :func:`add_launches`
read and raise all of them at once: what a caller that replays captured
launches (a CUDA graph calls no Python) needs to keep them true.
"""

from typing import Dict, Optional, Tuple

from . import adamw, flash_attention, mamba2_ssd, ops, ref, train_attention

__all__ = ["adamw", "flash_attention", "mamba2_ssd", "ops", "ref", "train_attention", "COUNTED",
           "launch_counts", "launches_since", "add_launches", "telemetry_counts"]

#: the counted wrappers by name, each with the names of its counter attributes
COUNTED = {
    "flash_attention": (flash_attention.flash_attention, ("launches", "launches_by_path")),
    "mamba2_ssd": (mamba2_ssd.mamba2_ssd, ("launches", "launches_by_path", "launches_by_plan")),
    "train_attention": (train_attention.train_attention, ("launches_by_kernel",)),
    "adamw": (adamw.adamw, ("launches_by_kernel",)),
}

#: the counters a traced run publishes, under the telemetry name each key
#: of theirs is appended to (``ssd.launches.<path>.p<p_block>``)
PUBLISHED = {("mamba2_ssd", "launches_by_plan"): "ssd.launches"}

#: every counter's value by ``(wrapper, counter, key)``, ``key`` None for an
#: integer counter
Counts = Dict[Tuple[str, str, Optional[str]], int]


def launch_counts() -> Counts:
    """Every counter of every counted wrapper, now."""
    out: Counts = {}
    for name, (wrapper, counters) in COUNTED.items():
        for counter in counters:
            value = getattr(wrapper, counter)
            if isinstance(value, dict):
                out.update({(name, counter, key): n for key, n in value.items()})
            else:
                out[(name, counter, None)] = value
    return out


def launches_since(before: Counts) -> Counts:
    """What each counter rose by since ``before`` (those that moved)."""
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)}


def add_launches(since: Counts, times: int) -> None:
    """Raises every counter by ``times`` x its rise in ``since`` (negative: lowers)."""
    for (name, counter, key), n in since.items():
        wrapper = COUNTED[name][0]
        if key is None:
            setattr(wrapper, counter, getattr(wrapper, counter) + times * n)
        else:
            counts = getattr(wrapper, counter)
            counts[key] = counts.get(key, 0) + times * n


def telemetry_counts(since: Counts) -> Dict[str, int]:
    """The telemetry counters (:data:`PUBLISHED`) the rises ``since`` tick."""
    return {f"{PUBLISHED[name, counter]}.{key}": n
            for (name, counter, key), n in since.items() if (name, counter) in PUBLISHED}
