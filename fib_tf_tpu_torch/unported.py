"""What the port does not carry yet, by the ROADMAP Queue 1 item that
ports it: every NotImplementedError of the kind cites its item from
`QUEUE1`, whose numbers ROADMAP.md keeps fixed."""

QUEUE1 = {
    "geometry": "ROADMAP Queue 1 items 9 and 18",   # 3D phase fields, fibers
    "engine": "ROADMAP Queue 1 item 14",            # the rest of Simulation
    "adaptive": "ROADMAP Queue 1 item 15",          # adaptive_dv
    "volume": "ROADMAP Queue 1 item 18",            # the volume's observables
    "parallel": "ROADMAP Queue 1 item 19",          # GSPMD, sharded probes
}


def not_ported(what: str, item: str):
    """Raise NotImplementedError: `what` is not ported yet, citing the
    Queue 1 item `item` (a key of QUEUE1)."""
    raise NotImplementedError(f"{what} is not ported yet ({QUEUE1[item]})")
