"""The device's idle time at a chunk boundary, in µs: from the end of the
chunk's last kernel to the start of the next chunk's `fibtorch.enqueue`
span within one `fibtorch.simulate` call (the read-back's copy, the probes'
consumption, a pacing event), the idle gaps of the traced window summed,
over the number of such boundaries.  The chunk's last kernel is the last
that starts before the read-back's device-to-host copy, the first
`Memcpy DtoH` record that starts inside the chunk's `fibtorch.readback`
span; so the gaps between the queued kernels that drain while the host
waits in the read-back are not counted, however far ahead the host ran
(`engine.launch_gap_us` reads those).  Where the read-back made no device
copy (the plain path on a CPU) the boundary starts with the read-back.
None where the window holds no boundary (one chunk, or no program
spans)."""

import bisect

from harness import spans
from harness.trace import TRANSFERS

UNIT = "us"


def drained(ctx, readback):
    """Where the device finished the chunk read back in `readback`."""
    r0, r1 = readback
    copy = next((a for n, a, _ in ctx.ops
                 if n.startswith("Memcpy DtoH") and r0 <= a <= r1), None)
    if copy is None:
        return r0
    ends = [b for n, a, b in ctx.ops
            if a < copy and not n.startswith(TRANSFERS)]
    return ends[-1] if ends else r0


def read(ctx):
    chunks = spans.named(ctx, "fibtorch.enqueue")
    readbacks = spans.named(ctx, "fibtorch.readback")
    starts = [a for a, _ in readbacks]
    idle = spans.Intervals(ctx.gaps)
    total, n = 0.0, 0
    for c0, c1 in spans.named(ctx, "fibtorch.simulate"):
        inner = [(a, b) for a, b in chunks if c0 <= a and b <= c1]
        for (_, end), (start, _) in zip(inner, inner[1:]):
            i = bisect.bisect_left(starts, end)
            if i == len(readbacks) or readbacks[i][0] >= start:
                continue
            total += idle.overlap(drained(ctx, readbacks[i]), start)
            n += 1
    return 1e6 * total / n if n else None
