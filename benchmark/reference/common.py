"""What every plain reference shares: the grid operators, the geometry and
pacing inputs worked out from the traffic's numbers, the Chebyshev fits,
and the run loop with the engine's event timing.

Plain PyTorch and numpy only.  Nothing here imports the program under
test; every derived input (phase field, pacing masks, fitted
coefficients) is worked out again from the published model and the
traffic's parameters.  Every function takes the dtype of the tensors it
is given, so the same code runs in float32 (the reference) and in
bfloat16 (the lower-precision control).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]


# -- grid operators ----------------------------------------------------------


def pad_reflect(x: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H+2, W+2], mirrored about the border cells."""
    return F.pad(x[None], (1, 1, 1, 1), mode="reflect")[0]


def no_flux_border(x: torch.Tensor) -> torch.Tensor:
    """The border rows and columns take the value of the cell next to
    them inward (the corners the diagonal one)."""
    return F.pad(x[None, 1:-1, 1:-1], (1, 1, 1, 1), mode="replicate")[0]


def laplacian(x: torch.Tensor,
              phase_padded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 9-point Laplacian (edge neighbours 1, corners 1/2, centre -6)
    on the reflect-padded field; with a phase field phi, plus the no-flux
    correction (grad x . grad phi) / (4 phi) by central differences."""
    p = pad_reflect(x)
    edges = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    corners = p[:-2, :-2] + p[2:, :-2] + p[:-2, 2:] + p[2:, 2:]
    lap = edges + 0.5 * corners - 6.0 * p[1:-1, 1:-1]
    if phase_padded is None:
        return lap
    q = phase_padded
    flux = ((p[2:, 1:-1] - p[:-2, 1:-1]) * (q[2:, 1:-1] - q[:-2, 1:-1])
            + (p[1:-1, 2:] - p[1:-1, :-2]) * (q[1:-1, 2:] - q[1:-1, :-2]))
    return lap + flux / (4.0 * q[1:-1, 1:-1])


# -- inputs derived from the traffic -----------------------------------------


def phase_field(height: int, width: int,
                holes: Sequence[Sequence[float]]) -> Optional[np.ndarray]:
    """The float32 phase field of the traffic's holes, or None without
    any.  A hole (x, y, r, 0) is a disk obstacle, 0.5 (tanh(d - r) + 1);
    (x, y, r, 1) keeps the disk and cuts everything outside it,
    0.5 (tanh(0.1 (r - d)) + 1).  Holes multiply; the field is floored
    at 1e-5, since the correction divides by it."""
    if not holes:
        return None
    cols, rows = np.meshgrid(np.arange(width), np.arange(height))
    phi = np.ones((height, width), np.float32)
    for x, y, r, outside in holes:
        d = np.sqrt((cols - x) ** 2.0 + (rows - y) ** 2.0)
        shape = (0.5 * (np.tanh(0.1 * (r - d)) + 1.0) if outside
                 else 0.5 * (np.tanh(d - r) + 1.0))
        phi = phi * shape.astype(np.float32)
    return np.maximum(phi, np.float32(1e-5)).astype(np.float32)


def pace_region(height: int, width: int, loc: str) -> tuple:
    """(row slice, column slice) of a named stimulus site: a 5-cell band
    at an edge, or one quadrant without the outermost cells."""
    h2, w2 = height // 2, width // 2
    return {
        "left": (slice(None), slice(0, 5)),
        "right": (slice(None), slice(width - 5, width)),
        "top": (slice(0, 5), slice(None)),
        "bottom": (slice(height - 5, height), slice(None)),
        "luq": (slice(1, h2), slice(1, w2)),
        "llq": (slice(h2, height - 1), slice(1, w2)),
        "ruq": (slice(1, h2), slice(w2, width - 1)),
        "rlq": (slice(h2, height - 1), slice(w2, width - 1)),
    }[loc]


def pace_mask(height: int, width: int, loc: str, v: float,
              floor: float) -> np.ndarray:
    """A stimulus as a mask that pacing takes the maximum with: `v` on the
    site, `floor` (at or under every potential) elsewhere."""
    m = np.full((height, width), floor, np.float32)
    m[pace_region(height, width, loc)] = v
    return m


# -- Chebyshev fits ------------------------------------------------------------


def power_basis_fit(v: np.ndarray, y: np.ndarray, deg: int) -> np.ndarray:
    """Least-squares Chebyshev fit of y(v) on [v.min(), v.max()], returned
    as float64 coefficients d of the chain S_0 = 1, S_1 = x,
    S_i = 2x S_(i-1) = 2^(i-1) x^i, with x the voltage mapped onto
    [-1, 1]."""
    c = np.polynomial.chebyshev.Chebyshev.fit(v, y, deg).coef
    p = np.polynomial.chebyshev.cheb2poly(c)
    scale = np.array([1.0] + [2.0 ** (i - 1) for i in range(1, deg + 1)])
    return p / scale


def power_chain(x: torch.Tensor, deg: int) -> List[torch.Tensor]:
    """[S_0 .. S_deg] of x."""
    chain = [torch.ones_like(x), x]
    two_x = 2.0 * x
    for _ in range(deg - 1):
        chain.append(two_x * chain[-1])
    return chain


def chain_sum(d: np.ndarray, chain: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_i d_i S_i with the coefficients rounded to float32."""
    d32 = np.asarray(d, np.float32)
    out = torch.full_like(chain[1], float(d32[0]))
    for di, s in zip(d32[1:], chain[1:]):
        out = out + float(di) * s
    return out


# -- runs ----------------------------------------------------------------------


def to_tensors(state: Mapping[str, np.ndarray], device,
               dtype=torch.float32) -> State:
    return {k: torch.as_tensor(np.asarray(v)).to(device=device, dtype=dtype)
            for k, v in state.items()}


def run(model, state: State, n_steps: int,
        events: Mapping[int, Sequence[torch.Tensor]] = {}) -> tuple:
    """`n_steps` outer steps of `model` from `state`.  After outer step k
    (1-based) the masks of `events[k]` fire: the potential takes the
    maximum with each.  Returns (state, {stream: [n_steps, ...] tensor}),
    a probe row taken after every outer step, before that step's
    events."""
    rows: Dict[str, List[torch.Tensor]] = {}
    for k in range(1, n_steps + 1):
        state = model.outer_step(state)
        for name, value in model.probes(state).items():
            rows.setdefault(name, []).append(value)
        for mask in events.get(k, ()):
            state = model.pace(state, mask)
    return state, {name: torch.stack(v) for name, v in rows.items()}


class GridModel:
    """What a family's reference shares: the grid, its phase field on the
    device, pacing, and the "v" probe (the potential at row 20, the
    middle column, mapped onto [0, 1] by the model's range and scaled by
    the phase field there).

    `ill_conditioned` marks every cell whose potential came within
    `POLE_MV` of one of the model's `POLES` in any substep the reference
    ran: a removable singularity of a rate formula (a difference over V
    minus its pole, which float32 evaluates as 0/0 or x/0 within ulps of
    it) or a branch point.  Two float32 evaluations of the same model
    part there by up to the gate's whole range, whichever is right."""

    min_v: float
    max_v: float
    pot_key = "V"
    POLES: tuple = ()
    POLE_MV = 1e-3

    def __init__(self, sim: Mapping, height: int, width: int,
                 phase: Optional[np.ndarray], device, dtype):
        self.sim = dict(sim)
        self.height, self.width = height, width
        self.device, self.dtype = device, dtype
        self.phase = phase
        self.phase_padded = (
            None if phase is None
            else pad_reflect(torch.as_tensor(phase).to(device=device,
                                                       dtype=dtype)))
        self.probe_pixel = (20, width // 2)
        self.probe_scale = (1.0 if phase is None
                            else float(phase[self.probe_pixel]))
        self.ill_conditioned = torch.zeros((height, width), dtype=torch.bool,
                                           device=device)

    def note_poles(self, v: torch.Tensor):
        for pole in self.POLES:
            self.ill_conditioned |= (v.float() - pole).abs() < self.POLE_MV

    def lap(self, v: torch.Tensor) -> torch.Tensor:
        return laplacian(v, self.phase_padded)

    def pace(self, state: State, mask: torch.Tensor) -> State:
        return {**state, self.pot_key: torch.maximum(state[self.pot_key],
                                                     mask)}

    def v_probe(self, state: State) -> torch.Tensor:
        r, c = self.probe_pixel
        v = state[self.pot_key][r, c].float()
        return ((v - self.min_v) / (self.max_v - self.min_v)
                * self.probe_scale)

    def probes(self, state: State) -> Dict[str, torch.Tensor]:
        return {"v": self.v_probe(state)}

    def probe_pixels(self) -> Dict[str, tuple]:
        """Where each probe stream is taken."""
        return {"v": self.probe_pixel}

    def outer_step(self, state: State) -> State:
        raise NotImplementedError


ModelFactory = Callable[..., GridModel]
