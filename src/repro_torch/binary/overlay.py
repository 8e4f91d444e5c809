"""SASSOverlay-style annotated disassembly.

Renders a kernel the way ``sassoverlay.py`` augments ``nvdisasm`` output:
each instruction line carries its text-section byte address and a control
column block

    [ stall Y | WRn RDn  wwwwww ]

where ``stall`` is the issue-stall count, ``Y`` marks a yielding slot,
``WRn``/``RDn`` are the write/read scoreboard barriers the instruction
*sets*, and ``wwwwww`` is the 6-bit mask of barriers it *waits* on.  This is
the debugging view for schedule inspection and predictor calibration: stall
chains and barrier round trips are visible at a glance, column-aligned.
"""

from __future__ import annotations

from typing import List, Union

from repro_torch.core.isa import Ctrl, Instr, Kernel, Label

from .archcodec import MAXWELL_CODEC


def format_ctrl_columns(ctrl: Ctrl) -> str:
    """One control word as a fixed-width ``[ .. | .. ]`` column block."""
    stall = str(ctrl.stall)
    y = "Y" if ctrl.yield_flag else " "
    wr = f"WR{ctrl.write_bar}" if ctrl.write_bar is not None else "   "
    rd = f"RD{ctrl.read_bar}" if ctrl.read_bar is not None else "   "
    wait = "".join(
        "1" if b in ctrl.wait else "0" for b in reversed(range(6))
    ) if ctrl.wait else "......"
    return f"[{stall:>2s} {y} | {wr} {rd} {wait} ]"


def _strip_ctrl_comment(rendered: str) -> str:
    """Drop the leading ``/*ww:r:w:y:s*/`` comment from ``Instr.render``."""
    if rendered.startswith("/*"):
        end = rendered.find("*/")
        if end != -1:
            return rendered[end + 2 :].lstrip()
    return rendered


def overlay_lines(
    kernel: Union[Kernel, List[object]], profile=None
) -> List[str]:
    """Annotated disassembly lines for a kernel (or raw item list).

    Addresses and packed control words follow the kernel's architecture
    codec (raw item lists use the Maxwell layout).

    ``profile`` (a :class:`repro_torch.obs.stallprof.StallProfile`, e.g. from
    ``simulate(kernel, profile=True)``) appends a hot-instruction column —
    attributed stall cycles, share of the kernel's total, dominant reason —
    to every line the simulator blamed, turning the schedule view into a
    profile view (``translate --profile``)."""
    items = kernel.items if isinstance(kernel, Kernel) else kernel
    codec = MAXWELL_CODEC
    lines: List[str] = []
    if isinstance(kernel, Kernel):
        from repro_torch.arch import arch_of

        codec = arch_of(kernel).codec
        arch_tag = "" if kernel.arch == "maxwell" else f"arch={kernel.arch} "
        lines.append(
            f"// kernel {kernel.name}  regs={kernel.reg_count} "
            f"threads/block={kernel.threads_per_block} "
            f"smem={kernel.shared_size}+{kernel.demoted_size}B "
            f"{arch_tag}ctrl=[stall Y | WR RD wait]"
        )
        if profile is not None:
            lines.append(
                f"// stall profile: {profile.total} attributed stall cycles "
                "(columns: cycles, share, dominant reason)"
            )
    by_index = profile.by_index() if profile is not None else {}
    body_width = max(
        (len(_strip_ctrl_comment(it.render())) for it in items if isinstance(it, Instr)),
        default=0,
    )
    idx = 0
    for it in items:
        if isinstance(it, Label):
            lines.append(it.render())
            continue
        body = _strip_ctrl_comment(it.render())
        line = (
            f"/*{codec.instr_addr(idx):04x}*/ {body:<{body_width}s}  "
            f"{format_ctrl_columns(it.ctrl)} /*{codec.pack_ctrl(it.ctrl):06x}*/"
        )
        entry = by_index.get(idx)
        if entry is not None:
            line += (
                f"  |{entry.total:>9d} {profile.share(entry):6.1%}"
                f" {entry.top_reason}"
            )
        lines.append(line)
        idx += 1
    return lines


def overlay(kernel: Union[Kernel, List[object]], profile=None) -> str:
    """Annotated disassembly as one string (see :func:`overlay_lines`)."""
    return "\n".join(overlay_lines(kernel, profile=profile))
