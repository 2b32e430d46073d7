"""The ctypes binding of one entry point of the port's CUDA libraries.

Every kernel wrapper (ops/cuda_*.py) binds its `extern "C"` entries with a
subclass of `Binding`.  The base class owns what they share:

- the library's spec: its `source`, the `defines` and extra nvcc `flags`
  it is built with and its `library_name` (build.py hashes the source, the
  headers it includes and the flags into the file's name);
- `build()` and `library()`: the library is built and loaded once, on the
  first launch; `library()` declares the entry's argument types (`ARGS`,
  then the probe's and, for a GEOM entry, the geometry's), checks that the
  library takes the parameter block and planes of the cell body the
  binding launches (`check_layout`) and runs the kernel's own checks
  (`check`);
- `call()`: the launch itself, which looks the entry up in `library()`,
  raises on a nonzero CUDA error and counts the launch in `launches`: per
  template flag ({"slow", "frozen"}) for a binding with `PER_FORM`, else
  one int.

A subclass declares its argument list and marshals its launch: it opens
the launch's span (`span_name`, `fibtorch.launch.<entry>`) around the
allocation of its outputs and `call()`, so that the span holds the host
operations of one launch.

Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

from fib_tf_tpu_torch.kernels import build

# an entry's C arguments by the code of their type in an argument list
_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint,
          "q": ctypes.c_longlong, "f": ctypes.c_float}
# the last arguments of every 2D entry: the probe buffer (may be null), its
# pixel and index, the device ordinal and the cudaStream_t
PROBE_2D = "probe:p probe_row:i probe_col:i probe_index:q device:i stream:p"
# a volume entry's: the probe's pixel has a slice
PROBE_3D = ("probe:p probe_z:i probe_row:i probe_col:i probe_index:q "
            "device:i stream:p")
# the GEOM entries' extra arguments: phase, dmap (device pointers or null),
# tensor flag, dxx, dxy, dyy (csrc/geometry.cuh Geometry)
GEOMETRY = "phase:p dmap:p tensor:i dxx:f dxy:f dyy:f"


def arguments(spec: str) -> tuple:
    """((name, ctypes type), ...) of an argument list: `spec`'s
    whitespace-separated `name:code` pairs, with the codes p (a pointer),
    i (int), u (unsigned int), q (long long) and f (float)."""
    return tuple((name, _TYPES[code])
                 for name, code in (a.split(":") for a in spec.split()))


GEOMETRY_ARGTYPES = [t for _, t in arguments(GEOMETRY)]


def check_layout(lib: ctypes.CDLL, entry: str, body):
    """The library's parameter block and planes for `entry` (its
    `<entry>_param_floats` and `<entry>_planes`) must be the ones `body`
    (ops/bodies.CellBody) packs."""
    sizes = []
    for what in ("param_floats", "planes"):
        fn = getattr(lib, f"{entry}_{what}")
        fn.argtypes = []
        fn.restype = ctypes.c_int
        sizes.append(fn())
    want = [body.param_floats, len(body.planes)]
    if sizes != want:
        raise RuntimeError(
            f"{entry} takes (param floats, planes) = {tuple(sizes)}, this "
            f"module packs {tuple(want)}")


class Binding:
    """ctypes binding of the entry `entry` of the library `library_name`,
    built from `source` with `defines` and `flags`, for the cell body
    `body`; `geom` adds the GEOM entries' arguments.  `layout` names the
    entry whose parameter block and planes the library reports (default
    `entry`)."""

    ARGS = ""            # the entry's arguments before the probe's
    PROBE = PROBE_2D
    PER_FORM = False     # count launches per template flag

    def __init__(self, entry: str, source: Path, library_name: str, body,
                 geom: bool = False, defines: tuple = (), flags: tuple = (),
                 layout: Optional[str] = None):
        self.entry = entry
        self.source = source
        self.library_name = library_name
        self.body = body
        self.geom = geom
        self.defines = tuple(defines)
        self.flags = tuple(flags)
        self.layout = entry if layout is None else layout
        self.span_name = f"fibtorch.launch.{entry}"
        self.arguments = arguments(
            f"{self.ARGS} {self.PROBE} {GEOMETRY if geom else ''}")
        self._lib = None
        self.reset_launches()

    @property
    def argtypes(self) -> list:
        return [t for _, t in self.arguments]

    def reset_launches(self):
        self.launches = {"slow": 0, "frozen": 0} if self.PER_FORM else 0

    def build(self) -> Path:
        """Build the library (if needed) and return its path."""
        return build.build(self.library_name, [self.source],
                           defines=self.defines, flags=self.flags)

    def library(self) -> ctypes.CDLL:
        """The loaded library, built and checked on the first call."""
        if self._lib is None:
            lib = build.load(self.library_name, [self.source],
                             defines=self.defines, flags=self.flags)
            fn = getattr(lib, self.entry)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            check_layout(lib, self.layout, self.body)
            self.check(lib)
            self._lib = lib
        return self._lib

    def check(self, lib: ctypes.CDLL):
        """The kernel's own checks of its library on load (none here)."""

    def call(self, *args, slow: bool = True):
        """Launch the entry with its C arguments `args`; raise
        RuntimeError on a CUDA error, naming the launch's scalar
        arguments; count the launch (as form `slow` with PER_FORM)."""
        err = getattr(self.library(), self.entry)(*args)
        if err != 0:
            shape = ", ".join(f"{name}={value}" for (name, kind), value
                              in zip(self.arguments, args)
                              if kind is not ctypes.c_void_p)
            raise RuntimeError(f"{self.entry} launch failed with CUDA "
                               f"error {err} ({shape})")
        if self.PER_FORM:
            self.launches["slow" if slow else "frozen"] += 1
        else:
            self.launches += 1
