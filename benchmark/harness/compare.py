"""The comparison that decides `correct`.  For each checked stage the
plain reference starts from the stage's input (the seed's state for the
start; the program's own state for an event's steps and for the
continuation after the window), runs the same outer steps with the same
events, and the stage's number is the widest gap between the program's
and the reference's outputs: every cell of every state plane, relative to
the reference plane's largest magnitude, and every sample of every probe
stream ("v" is on [0, 1] and compared as it is; the columns of the other
streams relative to their largest magnitude).  A non-finite output reads
as an infinite gap.  Left out: the cells the reference marks as
ill-conditioned in the stage (its potential within a hair of a pole of
the model's rate formulas), with their eight neighbours, and a probe
stream taken at such a cell."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import pace_mask, run, to_tensors


def widest(prog: torch.Tensor, ref: torch.Tensor, relative: bool) -> float:
    ref = ref.float()
    d = torch.nan_to_num((prog.float() - ref).abs(), nan=float("inf"),
                         posinf=float("inf"))
    gap = float(d.max())
    if relative:
        scale = float(ref.abs().max())
        gap = gap / scale if scale > 0 else gap
    return gap


def stage_gap(prog_state: Mapping, prog_probes: Mapping, ref,
              leave_out: bool = True) -> Tuple:
    """(widest gap, where it is) between the program's stage outputs and
    the reference run `ref`; `leave_out=False` keeps the ill-conditioned
    cells in (the calibration records that reading beside)."""
    keep = ~F.max_pool2d(ref.ill_conditioned.float()[None, None], 3,
                         stride=1, padding=1)[0, 0].bool()
    if not leave_out:
        keep = torch.ones_like(keep)
    found: List[Tuple[float, str]] = []
    for k, r in ref.state.items():
        p = torch.as_tensor(np.asarray(prog_state[k])).to(r.device)
        found.append((widest(p[keep], r[keep], True), k))
    for name, r in ref.probes.items():
        if not keep[ref.pixels[name]]:
            continue
        p = torch.as_tensor(np.asarray(prog_probes[name])).to(r.device)
        if name == "v":
            found.append((widest(p, r, False), "probe v"))
            continue
        r = r.reshape(r.shape[0], -1)
        p = p.reshape(p.shape[0], -1)
        for j in range(r.shape[1]):
            found.append((widest(p[:, j], r[:, j], True),
                          f"probe {name}[{j}]"))
    return max(found, key=lambda g: (np.nan_to_num(g[0], nan=np.inf), g[1]))


@dataclasses.dataclass
class ReferenceRun:
    state: Dict[str, torch.Tensor]
    probes: Dict[str, torch.Tensor]
    ill_conditioned: torch.Tensor        # [H, W] bool
    pixels: Dict[str, Tuple[int, int]]   # where each probe stream is taken


def reference_run(ref_module, cell, phase, state_in: Mapping,
                  n_steps: int, events: List[Tuple[int, str]], device,
                  dtype=torch.float32):
    """The reference's run of `n_steps` outer steps from `state_in`, with
    the stage's events (steps from its start, op)."""
    h, w = cell.traffic["grid"]
    model = ref_module.Model(cell.config["sim"], h, w, phase, device, dtype)
    masks: Dict[int, List[torch.Tensor]] = {}
    for k, op in events:
        spec = cell.traffic["pace_ops"][op]
        m = pace_mask(h, w, spec["loc"], float(spec["v"]), model.min_v)
        masks.setdefault(k, []).append(
            torch.as_tensor(m).to(device=device, dtype=dtype))
    with torch.no_grad():
        state, probes = run(model, to_tensors(state_in, device, dtype),
                            n_steps, masks)
    return ReferenceRun(state, probes, model.ill_conditioned,
                        model.probe_pixels())
