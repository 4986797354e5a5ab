"""CUDA-graph capture of the fleet step: the step loop's device work as
replays of graphs captured once per signature, so a step costs the host a
few graph launches instead of one dispatch per PyTorch op.

`FleetRunner.run` hands each step of a run on the card to `StepGraphs.step`.
A step is three pieces:
  begin  the SQP state from the carry and the duals, the lifted state;
  iter   one SQP iteration (replayed once an iteration of a warm step, with
         `mpc()`'s done-flag read on the host between iterations; a steady
         step's single shot, with the K-inverse carry where the runner has it);
  end    the record row and the advance (plant step, observation, exits,
         the shifted guesses and duals).
The first use of a piece runs it eagerly (its kernels warm up there: the
library's build, each kernel's attributes) and then captures it. The capture
cuts a new graph at both ends of each timed span (sqp.linearize,
qp.condense, each qp.kinv round, plant.step; utils/profiling.spans), and a
replay opens the spans between the graphs in the order the capture met them,
so a span's CUDA events enclose the replays of its phase.

Tensors pass between pieces in static buffers, by name. A piece copies in
the inputs that are not its buffers already (a step's window of X_targ and
U_targ, the run's initial state, a restored checkpoint) and leaves its
outputs in the buffers; the run's constant inputs (plants, model, costs) are
copied in once a run (`bind`). All graphs of a signature share one memory
pool; whatever outlives a piece sits in a buffer allocated outside the
capture, so the pool holds only a piece's temporaries.

The cache is process-wide, since `batched_mpc` builds a runner a call, and
keyed by `signature`: everything that selects the code of a piece. A run
stays eager where `eager_reason` gives a reason: off the card, with
model_fns (the sharded contractions and their collectives), with a streaming
refit, on the chol QP (its host reads). There is no switch; a test or a probe may set
the private `FleetRunner._graphs` to False.

Counters, as utils.profiling.host_flag.reads: StepGraphs.captures (graphs
captured), StepGraphs.replays (graphs replayed), StepGraphs.eager (pieces
run eagerly on the card, each on its first use before its capture). The
kernels' launch counters (boxqp_small / admm_big / expm_small.launches)
count each replay's launches and not the capture's.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Optional

import torch

from ..kernels import _graph
from ..kernels.admm_big import admm_big
from ..kernels.boxqp import boxqp_small
from ..kernels.expm import expm_small
from ..models.dmdc import tree_map
from ..plants.base import Plant
from ..utils.profiling import host_flag, spans
from .driver import (Carry, SQPState, StepContext, advance, bilinear_model, record_row,
                     sqp_init)

# signatures whose graphs the cache keeps, the least recently used dropped first
MAX_SIGNATURES = 8
# the kernel wrappers whose `launches` a replay adds to
_KERNELS = (boxqp_small, admm_big, expm_small)

# the static buffers' names: the carry, the duals, the SQP state, the record row
CARRY = tuple("c." + f for f in Carry._fields)
DUALS = ("d.y", "d.rho")
SQP = tuple("s." + f for f in SQPState._fields)
ROW = ("row.u", "row.obj", "row.iters", "row.active")


def eager_reason(runner, device, streaming: bool) -> Optional[str]:
    """Why a run of `runner` on `device` stays eager, or None where its
    steps are captured."""
    if torch.device(device).type != "cuda":
        return "not on the card"
    if runner.model_fns is not None:
        return "model_fns"
    if streaming:
        return "streaming refit"
    if runner.qp_kernel == "chol":
        return "chol QP"
    if not runner._graphs:
        return "forced"
    return None


def _setting(value):
    """A setting as a key: itself where hashable, else its identity."""
    try:
        hash(value)
    except TypeError:
        return ("id", id(value))
    return value


def _sig(obj):
    """What selects the code in a tensor (shape, dtype, device), or in a
    dataclass tree of them (a plant, a model: its type, its settings and
    its tensors' signatures); a setting as itself."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.dtype, str(obj.device))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(
            (f.name, _setting(getattr(obj, f.name)) if f.metadata.get("static")
             else _sig(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    return _setting(obj)


def _identity(obj):
    """A callable as a key: by identity (it may hold tensors the graphs read)."""
    return None if obj is None else ("id", id(obj))


def signature(runner, plants: Plant, model, Q_s, R_s, X_targ, U_targ, x0, noise,
              observe_fn, record: bool) -> tuple:
    """The cache key of a run: device, lanes, the dtypes and shapes of the
    plants, model, costs, targets, state and noise, the horizon and
    controls, the QP route and its BoxQPParams (warm and steady), the dual
    seeding, the K-inverse carry, the early exit, the box, the expm budget,
    the exit condition and the observation, and the record. Values of
    tensors (detunings, states, targets) and the loop's lengths are not in it."""
    cfg = runner.config
    return (str(plants.device), plants.lanes, _sig(plants), _sig(model), _sig(Q_s), _sig(R_s),
            _sig(X_targ)[1:], _sig(U_targ)[1:], x0.shape[-1], x0.dtype,
            cfg.horizon, cfg.dim_u, cfg.order, cfg.dt, cfg.step_tol, cfg.solver,
            cfg.qp_backend, cfg.qp_params, runner.steady_qp_params, runner.qp_kernel,
            runner.sat, runner.du, runner.carry_duals, runner.carry_kinv, runner.early_exit,
            runner.expm_taylor_k, runner.expm_max_squarings,
            _identity(runner.exit_condition), _identity(observe_fn),
            None if noise is None else (tuple(noise.shape[1:]), noise.dtype), bool(record))


def piece_keys(runner, step: int, kinv) -> tuple:
    """The pieces of step `step` within a signature: begin; the SQP
    iteration, by single-shot, the slew anchor (the last applied control
    after step 1) and a given K-inverse; end, by the measurement branch."""
    cfg = runner.config
    warm = step <= 1 or not cfg.warm_start
    return (("begin",),
            ("iter", not warm, step > 1, kinv is not None and not warm),
            ("end", (step + 1) % cfg.measure_freq == 0))


_CACHE: "collections.OrderedDict[tuple, StepGraphs]" = collections.OrderedDict()


def for_run(runner, plants: Plant, model, Q_s, R_s, X_targ, U_targ, x0, noise, observe_fn,
            streaming: bool, record: bool) -> Optional["StepGraphs"]:
    """The captured steps of a run, bound to its constant inputs, or None
    where the run stays eager (`eager_reason`)."""
    if eager_reason(runner, plants.device, streaming) is not None:
        return None
    key = signature(runner, plants, model, Q_s, R_s, X_targ, U_targ, x0, noise, observe_fn,
                    record)
    graphs = _CACHE.pop(key, None)
    if graphs is None:
        graphs = StepGraphs(plants.device, keep=(runner.exit_condition, observe_fn))
        while len(_CACHE) >= MAX_SIGNATURES:
            _CACHE.popitem(last=False)
    _CACHE[key] = graphs
    graphs.bind(plants, model, Q_s, R_s)
    return graphs


def _launches() -> tuple:
    return tuple(k.launches for k in _KERNELS)


def _add_launches(delta, sign: int) -> None:
    for k, d in zip(_KERNELS, delta):
        k.launches += sign * d


def _plant_map(fn, plant: Plant, *rest) -> Plant:
    """The plant with fn applied to each tensor field, across `rest` plants
    of the same kind (a wrapped plant's fields in turn)."""
    out = {}
    for name, t in plant.tensor_fields().items():
        others = [getattr(r, name) for r in rest]
        out[name] = _plant_map(fn, t, *others) if isinstance(t, Plant) else fn(t, *others)
    return dataclasses.replace(plant, **out)


class _Mark:
    """A span site met during a capture: it cuts the graph at both ends of a
    timed span and puts the span's opening and closing into the script."""

    __slots__ = ("cap", "name", "events", "attrs")

    def __init__(self, cap: "_Capture", name: str, events: bool, attrs):
        self.cap, self.name, self.events, self.attrs = cap, name, events, attrs

    def __enter__(self):
        if self.events:
            self.cap.cut()
        self.cap.ops.append(("open", self.name, self.events, self.attrs or {}))
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            if self.events:
                self.cap.cut()
            self.cap.ops.append(("close",))
        return False


class _Capture:
    """One piece's capture into a script: ("graph", graph, launches by
    kernel) for each non-empty graph, ("open", name, events, attrs) and
    ("close",) for the spans between them."""

    def __init__(self, pool):
        self.pool, self.ops, self.graph, self.mark = pool, [], None, None

    def span(self, name: str, events: bool, attrs) -> _Mark:
        return _Mark(self, name, events, attrs)

    def begin(self) -> None:
        self.mark = _launches()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # an empty graph (no work between two marks) warns
            graph.capture_end()
        # the wrappers counted the captured launches: a replay counts them
        delta = tuple(a - b for a, b in zip(_launches(), self.mark))
        _add_launches(delta, -1)
        if _graph.node_count(graph):
            graph.instantiate()
            self.ops.append(("graph", graph, delta))
            StepGraphs.captures += 1

    def cut(self) -> None:
        self.end()
        self.begin()

    def abort(self) -> None:
        if self.graph is not None:
            graph, self.graph = self.graph, None
            _add_launches(tuple(a - b for a, b in zip(_launches(), self.mark)), -1)
            try:
                graph.capture_end()
            except RuntimeError:
                pass


class StepGraphs:
    """The captured pieces of one signature, their static buffers, the
    run's constant inputs as static copies, and the pool the graphs share."""

    captures = 0
    replays = 0
    eager = 0

    def __init__(self, device, keep: tuple = ()):
        """:param keep: the objects whose identity the signature holds (the
        exit condition, the observation), kept alive with the graphs."""
        self.device = torch.device(device)
        self.keep = keep
        # the graphs' memory pool and capture stream, made at the first capture
        self.pool = self.stream = None
        self.static: dict = {}
        self.scripts: dict = {}
        self.plants = self.model = self.Q_s = self.R_s = None

    def bind(self, plants: Plant, model, Q_s, R_s) -> None:
        """Copy a run's constant inputs into the static ones (made on the
        first run)."""
        if self.plants is None:
            self.plants = _plant_map(torch.clone, plants)
            self.model = tree_map(torch.clone, model)
            self.Q_s, self.R_s = Q_s.clone(), R_s.clone()
            return
        _plant_map(lambda s, t: s.copy_(t), self.plants, plants)
        tree_map(lambda s, t: s.copy_(t), self.model, model)
        self.Q_s.copy_(Q_s)
        self.R_s.copy_(R_s)

    def step(self, runner, step: int, carry: Carry, duals, X_targ, U_targ, kinv, kinv_counts,
             noise_t, observe_fn, record: bool):
        """`FleetRunner.step` of every lane as replays: (carry, duals, the
        step's SQPState, kinv, the record row or None). The carry, duals,
        state and K-inverse returned are static buffers, valid until the
        next step of this signature; `kinv_counts` is updated in place."""
        cfg = runner.config
        H = cfg.horizon
        keys = piece_keys(runner, step, kinv)
        warm = not keys[1][1]
        start = max(step - 1, 0)
        v = dict(zip(CARRY, carry))
        v.update(zip(DUALS, duals))
        v["ctx.X_ref"] = X_targ[:, start:start + H + 1]
        v["ctx.U_ref"] = U_targ[:, start:start + H]
        for name, t in (("noise_t", noise_t), ("kinv", kinv), ("counts", kinv_counts)):
            if t is not None:
                v[name] = t
        mode = "replay" if all(k in self.scripts for k in keys) else "capture"
        with spans.span("fleet.step", phase="warm" if warm else "steady", graph=mode):
            self._piece(keys[0], v, self._begin)
            iterate = lambda u: self._iter(runner, u, keys[1])
            if warm:
                n_it = runner.warm_sqp_iters[min(step, len(runner.warm_sqp_iters) - 1)]
                for it in range(n_it):
                    self._piece(keys[1], v, iterate)
                    if runner.early_exit and it + 1 < n_it and host_flag(v["flag"]):
                        break
            else:
                self._piece(keys[1], v, iterate)
            self._piece(keys[2], v, lambda u: self._end(runner, u, step, observe_fn, record))
        if kinv_counts is not None and v["counts"] is not kinv_counts:
            kinv_counts.copy_(v["counts"])
        return (Carry(*(v[k] for k in CARRY)), (v["d.y"], v["d.rho"]),
                SQPState(*(v[k] for k in SQP)), v.get("kinv"),
                tuple(v[k] for k in ROW) if record else None)

    # -- the pieces: functions of the named tensors, run eagerly or captured

    def _begin(self, v: dict) -> dict:
        carry = Carry(*(v[k] for k in CARRY))
        out = dict(zip(SQP, sqp_init(carry, (v["d.y"], v["d.rho"]))))
        out["ctx.lift_x"] = self.plants.lift(carry.x_cur)
        return out

    def _iter(self, runner, v: dict, key: tuple) -> dict:
        _, single_shot, from_carry, kinv_given = key
        cfg = runner.config
        U_ref, u_last = v["ctx.U_ref"], v["c.u_last"]
        ctx = StepContext(v["ctx.X_ref"], U_ref, v["ctx.lift_x"],
                          u_last if from_carry else U_ref[:, 0].expand_as(u_last))
        kinv = v["kinv"] if kinv_given else None
        qp = runner.steady_qp_params if single_shot else cfg.qp_params
        s, res = runner._sqp_iter(SQPState(*(v[k] for k in SQP)), ctx,
                                  bilinear_model(self.model, cfg), self.model.A, self.Q_s,
                                  self.R_s, qp, single_shot, kinv0=kinv)
        out = dict(zip(SQP, s))
        if single_shot and runner.carry_kinv:
            out["kinv"] = runner._carry_kinv(kinv, res, v["c.done"], v.get("counts"))
        if runner.early_exit and not single_shot:
            out["flag"] = s.done.all()
        return out

    def _end(self, runner, v: dict, step: int, observe_fn, record: bool) -> dict:
        cfg = runner.config
        carry = Carry(*(v[k] for k in CARRY))
        s = SQPState(*(v[k] for k in SQP))
        ctx = StepContext(v["ctx.X_ref"], v["ctx.U_ref"], v["ctx.lift_x"], None)
        out = dict(zip(ROW, record_row(carry, s))) if record else {}
        carry, duals, _ = advance(carry, s, step, cfg, ctx, bilinear_model(self.model, cfg),
                                  self.model, self.plants, runner._plant_stepper(self.plants),
                                  runner.exit_condition, noise_t=v.get("noise_t"),
                                  observe_fn=observe_fn)
        out.update(zip(CARRY, carry))
        out.update(zip(DUALS, duals))
        return out

    # -- running a piece

    def _piece(self, key: tuple, v: dict, fn) -> None:
        """Run the piece `key` on the named tensors `v` and put its outputs
        into `v`: its replay, or on first use one eager call and its capture."""
        script = self.scripts.get(key)
        if script is None:
            StepGraphs.eager += 1
            inputs = dict(v)
            out = fn(v)
            self._capture(key, fn, inputs, out)
            v.update(out)
            return
        self._copy_in(v)
        _replay(script[0])
        for name in script[1]:
            v[name] = self.static[name]

    def _copy_in(self, v: dict) -> None:
        """Copy into the static buffers the named tensors that are not
        theirs, each then read from its buffer."""
        pairs = [(name, self.static[name], t) for name, t in v.items()
                 if name in self.static and t is not self.static[name]]
        if not pairs:
            return
        # a source in another name's buffer is read before that buffer is written
        written = {dst.untyped_storage().data_ptr() for _, dst, _ in pairs}
        pairs = [(name, dst, src.clone() if src.untyped_storage().data_ptr() in written else src)
                 for name, dst, src in pairs]
        for name, dst, src in pairs:
            dst.copy_(src)
            v[name] = dst

    def _capture(self, key: tuple, fn, inputs: dict, out: dict) -> None:
        """Capture fn on the static buffers of `inputs` into the script of
        `key`; its outputs (shaped as `out`) are copied into their buffers at
        its end. Buffers are made here, outside the capture, on first need."""
        for name, t in (*inputs.items(), *out.items()):
            if name not in self.static:
                self.static[name] = torch.empty_like(t, memory_format=torch.contiguous_format)
        self.scripts[key] = (self._record(fn, {name: self.static[name] for name in inputs}),
                             tuple(out))

    def _write(self, res: dict) -> None:
        """Copy a piece's outputs into their buffers (inside its capture)."""
        writes = {n: t for n, t in res.items() if t is not self.static[n]}
        # an output in another output's buffer is copied before that buffer is written
        written = {self.static[n].untyped_storage().data_ptr() for n in writes}
        writes = {n: t.clone() if t.untyped_storage().data_ptr() in written else t
                  for n, t in writes.items()}
        for n, t in writes.items():
            self.static[n].copy_(t)

    def _record(self, fn, sv: dict) -> list:
        """The script of fn captured on the buffers `sv`."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        cap = _Capture(self.pool)
        with torch.cuda.stream(self.stream):
            spans.capture = cap
            try:
                cap.begin()
                res = fn(sv)
                self._write(res)
                cap.end()
            except BaseException:
                cap.abort()
                raise
            finally:
                spans.capture = None
        current.wait_stream(self.stream)
        return cap.ops


def _replay(ops: list) -> None:
    """Replay a piece's script: its graphs on the current stream, its spans
    opened and closed between them."""
    opened = []
    for op in ops:
        kind = op[0]
        if kind == "graph":
            op[1].replay()
            _add_launches(op[2], 1)
            StepGraphs.replays += 1
        elif kind == "open":
            ctx = spans.span(op[1], op[2], **op[3])
            ctx.__enter__()
            opened.append(ctx)
        else:
            opened.pop().__exit__(None, None, None)
