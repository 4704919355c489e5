"""Step bodies captured as CUDA graphs: the port's counterpart of ``jax.jit``.

JAX compiles each train step, eval step and serving call into one program,
so a call is one dispatch (``hdenseformer_tpu/train/loop.py``
``make_train_step`` / ``make_eval_step``, ``infer/sliding.py``'s scanned
windows). On a card the port captures a step body once as a CUDA graph on
static input buffers and replays it for every call of the same shapes: the
kernels of a step run without Python between their launches.

``CapturedCall`` is one such graph:

- the warm-up runs the body once eagerly on a side stream, so that the
  kernels are built, cuDNN's plans chosen and lazily made state (an
  optimizer's moments, the s2d gather indices) exists before the capture;
  with ``restore`` everything the warm-up changed (parameters, buffers,
  the optimizer's state, the generators) is then put back, so the warm-up
  is not a step of the run;
- the capture registers the generators with the graph (their seed and
  offset are read on the card at replay) and, for a checkpointed model,
  the dropout states of ``models.hdenseformer.RematGraphRng``;
- a replay copies the call's tensors into the static buffers, syncs those
  dropout states to the generators as the caller seeded them, replays, and
  returns clones of the outputs.

On a CPU tensor there is no graph: the body runs directly on the static
buffers at each call (the host side alone, which the CPU tests hold against
the eager step). A capture the card refuses raises; nothing falls back to
the eager body on a card. The kernel wrappers count their launches in
Python, so under a graph they count the warm-up's and the capture's, once.

Spans (``utils.profiling``), each keyed by the graph's key: ``graph.warmup``
(the call made: static buffers and the eager run), ``graph.capture``, and
``graph.replay`` with ``graph.copy_in`` (the copies into the static
buffers) and ``graph.launch`` (the dropout states' sync and the launch; on
the CPU the body) as children, the output clones its own time. Counters
``graphs.captured`` and ``graphs.replayed``.

``GraphCache`` holds the captured calls of a run by key, all in one memory
pool: a run's train and eval graphs never run at once, and separate pools
would add their peaks. A graph keeps the addresses of the tensors it reads
and writes: an optimizer state loaded after its capture (``load_state_dict``
makes new tensors) needs a new cache, so the trainer captures only after
``load_pretrained``. ``model_graphs`` is a model's serving cache (the
sliding-window call per lattice cell, the 2-D slice chunks), dropped when
the model's parameters are rebound.

Under a data-parallel mesh whose backend is NCCL the collectives of a body
are captured with it (``parallel.mesh.check_capturable`` refuses gloo on a
card). Every rank must then capture on the same call, or one rank captures
while another replays and the collectives never meet: the callers key their
graphs by shapes that agree on every rank (``pad_and_mask_batch``'s global
batch shapes, the lattice cell of a volume every rank serves), and each
rank's warm-up runs its collectives in the same order, which also creates
the NCCL communicator before the capture.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch

from hdenseformer_tpu_torch.models.hdenseformer import RematGraphRng
from hdenseformer_tpu_torch.utils.profiling import count, span


def batch_key(batch: Dict[str, torch.Tensor]) -> tuple:
    """The names, shapes and dtypes of a call's tensors: a graph's key."""
    return tuple((n, tuple(v.shape), v.dtype) for n, v in sorted(batch.items()))


class CapturedCall:
    """``body(static) -> {name: tensor}`` as one CUDA graph on ``static``.

    ``example`` gives the static buffers' shapes, dtypes and device (its
    values are copied in for the warm-up). ``generators`` (None entries
    skipped) are the ones the body draws from; the first is the dropout
    generator that ``remat_call`` may checkpoint. ``restore`` is the
    (model, optimizer) whose state the warm-up leaves as it was, or None
    where the body changes no state (an eval step, a serving forward).
    """

    def __init__(self, body: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                 example: Dict[str, torch.Tensor], generators: Sequence = (),
                 restore: Optional[tuple] = None, pool=None):
        self.body = body
        self.static = {n: v.detach().clone() for n, v in example.items()}
        self.generators = [g for g in generators if g is not None]
        self.on_card = next(iter(self.static.values())).device.type == "cuda"
        dropout = self.generators[0] if self.generators else None
        self.rng = (RematGraphRng(dropout) if self.on_card and dropout is not None
                    and dropout.device.type == "cuda" else None)
        self.pool = pool
        self.graph, self.out = None, None
        self.key = None  # the GraphCache's key, for the spans
        self._warmup(restore)

    def _warmup(self, restore: Optional[tuple]) -> None:
        """One eager run of the body (on a side stream on the card), then
        what it changed put back where ``restore`` says (a state the run
        created is zeroed: Adam's fresh moments and counter), and the
        generators where they were."""
        tensors, saved, before = [], [], {}
        if restore is not None:
            model, opt = restore
            tensors = list(model.parameters()) + list(model.buffers())
            saved = [t.detach().clone() for t in tensors]
            before = {p: {n: v.clone() for n, v in st.items() if torch.is_tensor(v)}
                      for p, st in opt.state.items()}
        gen_states = [g.get_state() for g in self.generators]
        if self.on_card:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            record = self.rng.recording() if self.rng else contextlib.nullcontext()
            with torch.cuda.stream(side), record:
                self.body(self.static)
            torch.cuda.current_stream().wait_stream(side)
        else:
            self.body(self.static)
        for g, st in zip(self.generators, gen_states):
            g.set_state(st)
        if restore is None:
            return
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
            for p, st in opt.state.items():
                for n, v in st.items():
                    if not torch.is_tensor(v):
                        continue
                    if p in before:
                        v.copy_(before[p][n])
                    else:  # created by the warm-up: Adam's moments and counter start at 0
                        v.zero_()
        opt.zero_grad(set_to_none=True)

    def capture(self) -> None:
        """Capture the body once (on a card; nothing on the CPU). Python's
        cyclic garbage is collected first: a dead call left in a reference
        cycle (a step and the cache that holds its graphs refer to each
        other) still holds its CUDA graph, and were the collector to destroy
        that graph while the stream captures, the capture would be
        invalidated."""
        if self.graph is not None or not self.on_card:
            return
        with span("graph.capture", self.key):
            gc.collect()
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            rng = self.rng.capturing(graph) if self.rng else contextlib.nullcontext()
            with rng, torch.cuda.graph(graph, pool=self.pool,
                                       capture_error_mode="thread_local"):
                self.out = self.body(self.static)
            self.graph = graph
        count("graphs.captured")

    def replay(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The body on ``batch``: copied into the static buffers, then the
        graph replayed (on the CPU the body called); clones of its outputs."""
        count("graphs.replayed")
        with span("graph.replay", self.key):
            with span("graph.copy_in", self.key):
                for n, v in batch.items():
                    self.static[n].copy_(v, non_blocking=True)
            if not self.on_card:
                with span("graph.launch", self.key):
                    out = self.body(self.static)
                return {n: v.clone() for n, v in out.items()}
            self.capture()
            with span("graph.launch", self.key):
                if self.rng is not None:
                    self.rng.sync()
                self.graph.replay()
            return {n: v.clone() for n, v in self.out.items()}


class GraphCache:
    """Captured calls by key, in one memory pool (made at the first call on
    a card); ``captured`` counts the graphs made so far."""

    def __init__(self):
        self.calls: Dict[tuple, CapturedCall] = {}
        self.pool = None
        self.tensors: tuple = ()  # model_graphs: the addresses the graphs read

    @property
    def captured(self) -> int:
        return len(self.calls)

    def get(self, key: tuple, make: Callable[[object], CapturedCall]) -> CapturedCall:
        """The call of ``key``, made by ``make(pool)`` the first time."""
        call = self.calls.get(key)
        if call is None:
            if self.pool is None and torch.cuda.is_available():
                self.pool = torch.cuda.graph_pool_handle()
            with span("graph.warmup", key):
                call = self.calls[key] = make(self.pool)
            call.key = key
        return call


# each model's serving graphs; a graph holds no reference to its model, so
# both go when the model does
_MODEL_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, GraphCache]" = (
    weakref.WeakKeyDictionary())


def model_graphs(model: torch.nn.Module) -> GraphCache:
    """The model's serving graphs. A graph reads the parameters and buffers
    at the addresses they had at its capture: where they were rebound since
    (``.to(dtype)``, ``load_state_dict(assign=True)``), the model's graphs
    are dropped and a new cache made."""
    tensors = tuple((t.data_ptr(), t.dtype)
                    for t in itertools.chain(model.parameters(), model.buffers()))
    graphs = _MODEL_GRAPHS.get(model)
    if graphs is None or graphs.tensors != tensors:
        graphs = _MODEL_GRAPHS[model] = GraphCache()
        graphs.tensors = tensors
    return graphs
