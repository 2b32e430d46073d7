"""Float32 operations per cell of one Beeler-Reuter outer step under
cheby + skip, counted by hand on the cell body (a logarithm counts as
one): each substep takes the 9-point stencil 10, the Chebyshev chain 10,
20 for the currents, 6 for Ca and 5 for V; the substep that advances the
slow gates evaluates 14 degree-8 fits at 16 each and updates 6 gates at 4
each, the four that hold them 6 fits and 2 gates.  So 299 + 4 x 155 = 919.
"""

STENCIL, CHAIN, REST = 10, 10, 31
FIT, GATE = 16, 4


def substep(slow: bool) -> int:
    fits, gates = (14, 6) if slow else (6, 2)
    return STENCIL + CHAIN + FIT * fits + GATE * gates + REST


def flops_per_cell_step(sim: dict, phase: bool) -> int:
    """Operations per cell of one outer step (one slow substep and four
    that hold the slow gates); `phase` adds the phase-field correction to
    each substep's stencil."""
    if not (sim.get("cheby") and sim.get("skip")):
        raise ValueError("counted for cheby + skip only")
    geometry = 10 if phase else 0
    return substep(True) + 4 * substep(False) + 5 * geometry
