"""Float32 operations per cell of one Courtemanche outer step on the
direct rates, counted by hand on the cell body (a transcendental or a
division counts as one): the currents both commits need 99, the fast
commit's own 79 and the 9-point stencil 10, the slow commit's own 383.
An outer step is one slow commit and ten fast commits; the phase-field
correction adds 10 to each fast commit (two differences of V, two of the
field, the flux 3, 4 phi, the division, the sum).  So 482 + 10 x 188
= 2362, or 2462 with a phase field.
"""

SHARED = 99
FAST_OWN, STENCIL = 79, 10
SLOW_OWN = 383
PHASE = 10
FAST_COMMITS = 10


def flops_per_cell_step(sim: dict, phase: bool) -> int:
    if sim.get("court_cheby") or sim.get("table"):
        raise ValueError("counted for the direct rates only")
    fast = SHARED + FAST_OWN + STENCIL + (PHASE if phase else 0)
    return SHARED + SLOW_OWN + FAST_COMMITS * fast
