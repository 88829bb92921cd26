"""A loop body captured once in a CUDA graph and replayed.

The port's counterpart of a jitted ``lax.while_loop`` or ``fori_loop``:
``CapturedBlock`` runs ``iterations`` iterations of a body over a dict of
carry tensors as one device program, with one host read ("is work left?")
per block, or none when the caller knows the count.  On CUDA the
first block runs eagerly on a side stream (it builds the kernel libraries
and fills every cache the body reads, so none is made inside the graph's
memory pool), then the same block is captured; every later block is a
replay.  On any other device every block runs as it is, with no graph.
The carries and everything the body reads stay at fixed addresses: the body
reads its inputs from the tensors of ``carries`` and writes the new carries
back into them at the end of the block.  A capture that fails raises
``CaptureError``, which a caller's retry of failed executions re-raises.
The eager first block and the capture are one ``capture`` span of the log
(``utils/profiling.py``), and the capture records the graph's stage map.
The capture launches nothing: the kernel launches it records leave
``kernels.launches`` and are added back at every replay, so the counter
holds the launches the card ran.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Callable, Dict, Optional

import torch

from .. import kernels
from ..utils.profiling import span, stage_map


def capture_node_counter(stream: torch.cuda.Stream) -> Callable[[], int]:
    """A function that reads how many nodes the CUDA graph being captured
    on ``stream`` holds so far (``libcuda``'s ``cuStreamGetCaptureInfo`` and
    ``cuGraphGetNodes``, a few microseconds a call)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    info, get_nodes = cuda.cuStreamGetCaptureInfo_v2, cuda.cuGraphGetNodes
    handle = ctypes.c_void_p(stream.cuda_stream)
    status, capture_id, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
    deps, n_deps, n = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_size_t()

    def count() -> int:
        rc = info(handle, ctypes.byref(status), ctypes.byref(capture_id), ctypes.byref(graph),
                  ctypes.byref(deps), ctypes.byref(n_deps))
        if rc != 0 or not graph.value or get_nodes(graph, None, ctypes.byref(n)) != 0:
            raise RuntimeError(f"cannot read the nodes of the graph being captured (CUresult {rc})")
        return n.value

    return count


class CaptureError(RuntimeError):
    """A CUDA graph capture failed: a fault of the body, not of one
    execution, so no retry may hide it."""


class CapturedBlock:
    """``iterations`` runs of ``step`` (carries -> new carries) as one CUDA
    graph (on CUDA); ``more(carries)`` is the [] bool the host reads after a
    block, or None for a body run a known number of times (no host read)."""

    captures = 0  # graphs captured, and
    replays = 0  # replays of every block: a run shows the graph ran

    def __init__(self, step: Callable[[dict], dict],
                 more: Optional[Callable[[dict], torch.Tensor]],
                 carries: Dict[str, torch.Tensor], iterations: int):
        self.step, self.more, self.iterations = step, more, iterations
        self.carries = carries
        self.device = next(iter(carries.values())).device
        self.flag = None if more is None else torch.ones((), dtype=torch.bool, device=self.device)
        self.graph = None
        self.graph_id = None  # the stage map's id of the captured graph
        self.per_replay = collections.Counter()  # kernel launches a replay runs

    def load(self, carries: Dict[str, torch.Tensor]) -> None:
        """Start from ``carries`` (copied into the captured tensors)."""
        for name, value in carries.items():
            self.carries[name].copy_(value)

    def _block(self) -> None:
        c = dict(self.carries)
        for _ in range(self.iterations):
            c = self.step(c)
        for name, value in self.carries.items():
            value.copy_(c[name])
        if self.flag is not None:
            self.flag.copy_(self.more(c))

    def _capture(self) -> None:
        dev = self.device
        with span("capture", iterations=self.iterations):
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._block()  # the first block, run for real
            main.wait_stream(side)
            before = kernels.launches.copy()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    with stage_map(capture_node_counter(torch.cuda.current_stream(dev))) as smap:
                        self._block()
            except Exception as err:
                raise CaptureError(f"CUDA graph capture failed: {err}") from err
        # The capture ran nothing: its launches count once per replay.
        self.per_replay = kernels.launches - before
        kernels.launches.subtract(self.per_replay)
        self.graph, self.graph_id = graph, smap.graph
        CapturedBlock.captures += 1

    def run(self) -> Optional[bool]:
        """One block of iterations; returns whether work is left (None
        without ``more``: then nothing is read back)."""
        if self.device.type != "cuda":
            self._block()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            CapturedBlock.replays += 1
            kernels.launches.update(self.per_replay)
        return None if self.flag is None else bool(self.flag)
