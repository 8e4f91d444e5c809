"""Register compaction via a relocation space (paper §3.3, Fig. 4).

Demoted registers leave gaps in the register numbering, but the ISA charges
a kernel by its *highest used register number*, so the space must be packed.
The relocation space is an array with one slot per physical register; gaps
are pushed toward the end with two operations:

* **shifting**  — move the next register down into the lowest gap;
* **swapping**  — when alignment blocks a multi-word register from shifting,
  exchange it with the *swapping window* (the ``width`` slots directly below
  it), which moves the pair down while preserving even alignment.

The §3.4.1 bank-conflict-aware variant first looks for a same-bank register
within a window of four to fill the gap, reverting to plain shifting when
that would strand an even-numbered gap (register count reduction is the top
priority).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from .isa import Kernel
from .candidates import width_map

NUM_BANK_WINDOW = 4  # swapping window for the bank-aware variant (§3.4.1)


def folded_widths(kernel: Kernel) -> Dict[int, int]:
    """Width map with pair aliases folded: if ``r`` is a 64-bit pair, a
    standalone single-word entry for ``r+1`` (the alias word, which code may
    still write individually, e.g. pair initialization) belongs to the pair
    and must not occupy its own relocation slot."""
    widths = width_map(kernel)
    for r, w in list(widths.items()):
        if w == 2 and widths.get(r + 1) == 1:
            del widths[r + 1]
    return widths


# ---------------------------------------------------------------------------
# Relocation space
# ---------------------------------------------------------------------------


class RelocationSpace:
    """One slot per physical register; multi-word registers occupy
    ``width`` consecutive slots but are represented (and moved) as a unit,
    which "prevents the algorithm from breaking register aliases"."""

    def __init__(self, kernel: Kernel):
        from repro_torch.arch import arch_of

        #: arch banking for the §3.4.1 bank-aware fill (Maxwell: reg % 4,
        #: Volta: reg % 2) — must match the model charging the conflicts
        self.reg_bank = arch_of(kernel).reg_bank
        widths = folded_widths(kernel)
        self.pinned: Set[int] = set(kernel.live_in) | set(kernel.live_out)
        top = max(widths) + max(widths.values(), default=1) if widths else 0
        self.slots: List[Optional[int]] = [None] * (top + 1)
        self.width: Dict[int, int] = {}
        for r, w in widths.items():
            # odd alias words were folded into their pair by width_map users;
            # guard anyway
            if any(self.slots[r + j] is not None for j in range(w)):
                continue
            for j in range(w):
                self.slots[r + j] = r
            self.width[r] = w
        #: final placement: original reg -> new leading position
        self.moves: Dict[int, int] = {}

    # -- queries --------------------------------------------------------------

    def lowest_gap(self, start: int = 0) -> Optional[int]:
        top = self.highest_used()
        for i in range(start, top):
            if self.slots[i] is None:
                return i
        return None

    def highest_used(self) -> int:
        for i in range(len(self.slots) - 1, -1, -1):
            if self.slots[i] is not None:
                return i + 1
        return 0

    def next_movable_above(self, pos: int) -> Optional[int]:
        """Leading slot index of the next movable register above ``pos``."""
        i = pos + 1
        top = self.highest_used()
        while i < top:
            r = self.slots[i]
            if r is not None and i == self._lead(i) and r not in self.pinned:
                return i
            i += 1
        return None

    def _lead(self, pos: int) -> int:
        r = self.slots[pos]
        while pos > 0 and self.slots[pos - 1] == r:
            pos -= 1
        return pos

    # -- operations -------------------------------------------------------------

    def place(self, lead_pos: int, new_pos: int) -> None:
        r = self.slots[lead_pos]
        w = self.width[r]
        for j in range(w):
            assert self.slots[lead_pos + j] == r
            self.slots[lead_pos + j] = None
        for j in range(w):
            assert self.slots[new_pos + j] is None, "placement collision"
            self.slots[new_pos + j] = r

    def shift(self, gap: int, lead_pos: int) -> bool:
        """Fig. 4(a)/(b): move the register at ``lead_pos`` into ``gap``."""
        r = self.slots[lead_pos]
        w = self.width[r]
        if w == 2 and gap % 2 != 0:
            return False  # alignment restriction (Fig. 4b)
        if any(
            gap + j >= lead_pos or self.slots[gap + j] is not None for j in range(w)
        ):
            if not all(
                gap + j < lead_pos and self.slots[gap + j] is None for j in range(w)
            ):
                return False
        self.place(lead_pos, gap)
        return True

    def swap_window(self, lead_pos: int) -> bool:
        """Fig. 4(c): exchange the multi-word register at ``lead_pos`` with
        the window of ``width`` slots directly below it."""
        r = self.slots[lead_pos]
        w = self.width[r]
        lo = lead_pos - w
        if lo < 0:
            return False
        window = self.slots[lo:lead_pos]
        # window must contain only movable single-word registers and gaps
        for x in set(window):
            if x is None:
                continue
            if x in self.pinned or self.width.get(x, 1) != 1:
                return False
        # perform the exchange: pair drops by w, window contents rise by w
        singles = [x for x in window if x is not None]
        for j in range(w):
            self.slots[lo + j] = r
        pos = lead_pos
        for x in singles:
            self.slots[pos] = x
            pos += 1
        for j in range(pos, lead_pos + w):
            self.slots[j] = None
        return True

    # -- the packing loop -------------------------------------------------------

    def pack(self, bank_avoid: bool = False) -> Dict[int, int]:
        guard = 0
        while True:
            guard += 1
            if guard > 10_000:  # pragma: no cover - defensive
                raise RuntimeError("compaction did not converge")
            gap = self.lowest_gap()
            if gap is None:
                break
            moved = False
            if bank_avoid:
                moved = self._bank_aware_fill(gap)
            if not moved:
                pos = self.next_movable_above(gap)
                if pos is None:
                    break
                if self.shift(gap, pos):
                    moved = True
                elif self.width[self.slots[pos]] == 2:
                    # alignment blocked the shift: swap first (Fig. 4c), the
                    # next iteration re-tries the (now lower) configuration
                    moved = self.swap_window(pos)
                    if not moved:
                        # give up on this gap: try the next register above
                        nxt = self.next_movable_above(pos)
                        if nxt is None:
                            break
                        moved = self.shift(gap, nxt) or self.swap_window(nxt)
                if not moved:
                    # nothing above fits this gap; look past it
                    nxt_gap = self.lowest_gap(start=gap + 1)
                    if nxt_gap is None or nxt_gap == gap:
                        break
                    continue
            if not moved:
                break
        return self.extract_moves()

    def _bank_aware_fill(self, gap: int) -> bool:
        """§3.4.1: prefer filling ``gap`` with a same-bank register found
        within a window of four slots above it."""
        # an even gap with a free odd neighbour should be saved for a pair if
        # one exists above ("we revert to the original algorithm in that case
        # since reducing register count is the top priority")
        pair_waiting = any(
            w == 2 and self.slots[r] == r
            for r, w in self.width.items()
            if r > gap and r not in self.pinned and self.slots[r] is not None
        )
        if (
            gap % 2 == 0
            and gap + 1 < len(self.slots)
            and self.slots[gap + 1] is None
            and pair_waiting
        ):
            return False
        pos = gap + 1
        seen = 0
        top = self.highest_used()
        while pos < top and seen < NUM_BANK_WINDOW:
            r = self.slots[pos]
            if r is not None and pos == self._lead(pos) and r not in self.pinned:
                seen += 1
                if self.width[r] == 1 and self.reg_bank(pos) == self.reg_bank(gap):
                    self.place(pos, gap)
                    return True
            pos += 1
        return False

    def extract_moves(self) -> Dict[int, int]:
        moves: Dict[int, int] = {}
        for i, r in enumerate(self.slots):
            if r is not None and (i == 0 or self.slots[i - 1] != r):
                if i != r:
                    moves[r] = i
                    if self.width.get(r, 1) == 2:
                        # the alias word moves with its pair (code may name
                        # it directly, e.g. MOV32I into the high word)
                        moves[r + 1] = i + 1
        return moves


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def compact(kernel: Kernel, bank_avoid: bool = False) -> Dict[int, int]:
    """Pack the register space in-place, renaming registers in the code.

    Returns the applied rename map (old -> new leading register number)."""
    space = RelocationSpace(kernel)
    moves = space.pack(bank_avoid=bank_avoid)
    if moves:
        _apply_renames(kernel, moves)
    return moves


def _apply_renames(kernel: Kernel, moves: Dict[int, int]) -> None:
    for ins in kernel.instructions():
        ins.dsts = [moves.get(r, r) for r in ins.dsts]
        ins.srcs = [moves.get(r, r) for r in ins.srcs]
    if kernel.rda is not None:
        kernel.rda = moves.get(kernel.rda, kernel.rda)


def packed_reg_count(kernel: Kernel) -> int:
    """Best-achievable register count after compaction (used as the loop
    condition in RegDem's while loop: ``p.reg_count`` post-packing)."""
    widths = folded_widths(kernel)
    pinned = (set(kernel.live_in) | set(kernel.live_out)) & set(widths)
    occupied: Set[int] = set()
    for r in pinned:
        for j in range(widths[r]):
            occupied.add(r + j)
    pairs = sorted(r for r, w in widths.items() if w == 2 and r not in pinned)
    singles = sorted(r for r, w in widths.items() if w == 1 and r not in pinned)
    for _ in pairs:
        pos = 0
        while pos % 2 or pos in occupied or pos + 1 in occupied:
            pos += 1
        occupied |= {pos, pos + 1}
    for _ in singles:
        pos = 0
        while pos in occupied:
            pos += 1
        occupied.add(pos)
    return (max(occupied) + 1) if occupied else 0
