"""Float32 operations per cell of one ten Tusscher-Panfilov 2006 outer step
with every gate advanced every dt, counted by hand on the cell body
(csrc/tp06_cell.cuh; a transcendental or a division counts as one): the
fast gates m, h, j, r, d, xr2 154, the slow gates f, f2, s, xr1, xs 131,
fCass 13, the twelve currents 135, the SR release, the fluxes and the
five pools 98, V 4 and the 9-point stencil 10, so 545 a substep.  An outer
step is ten such substeps: 5450.
"""

FAST_GATES, SLOW_GATES, FCASS = 154, 131, 13
CURRENTS, POOLS, V, STENCIL = 135, 98, 4, 10
SUBSTEPS = 10


def substep() -> int:
    return FAST_GATES + SLOW_GATES + FCASS + CURRENTS + POOLS + V + STENCIL


def flops_per_cell_step(sim: dict, phase: bool) -> int:
    if sim.get("skip"):
        raise ValueError("counted with every gate advanced every dt")
    if sim.get("cell_type", "epi") == "transmural":
        raise ValueError("counted without het planes")
    if phase:
        raise ValueError("counted without a phase field")
    return SUBSTEPS * substep()
