"""A gloo process group of the port for the multi-rank tests, and its worker.

:class:`Group` starts N worker processes on the CPU (this file run as a
script), which bring up one gloo group through a ``file://`` store and then
run jobs until they are closed: each job goes to every rank, and each rank's
answer comes back. The workers import torch and the port only, never JAX;
the test process computes the JAX package's side and hands the workers
numpy arrays. One group serves all the cases of a test file (a
module-scoped fixture), so the start-up is paid once a file.

Jobs (``JOBS``):

* ``train``: the port's data-parallel steps (``grad_accum`` microbatches a
  step) of a model by registry name or ``(class name, kwargs)``
  (:func:`build_model`) from given weights, batches, per-rank codec draws
  and dropout keep-masks; every rank returns each step's metrics and a hash of
  its parameters and buffers, rank 0 its final state. With ``resume_at`` the
  run is cut after that many steps: rank 0 saves a checkpoint into
  ``train_dir``, and every rank loads it into a fresh model and optimizer
  state and goes on; ``hybrid`` (a pickled ``HybridPlan``) runs the
  sparse-row exchange, and each step's ``row_overflow`` comes back; with
  ``parts`` the steps run as superstep blocks of those sizes (the block
  step of ``superstep=k``, each rank on its rows of every step of the
  block), each step's metrics taken from the block's series and the hash
  after a block's last step only (None inside a block); ``guard`` (a max
  grad norm) arms the guard with ``chaos`` (a spec) aimed at
  ``target_replica``, each step's ``skipped`` and ``dropped`` coming back;
  ``track_quality`` arms the quality probes, each step's ``q_err2`` and
  ``q_rel`` coming back as lists; ``partition`` (``zero1`` or
  ``sharded-update``) runs the partitioned update (``mesh.update``), the
  hash taken on the materialized parameters, each step's persistent state
  bytes coming back; with ``optimizer`` ((name, kwargs) of
  ``make_optimizer``) in place of sgd; ``quorum`` ((Q, K)) runs the quorum
  step fed ``arrivals[s]`` at step s, each step's ``quorum_kept``,
  ``stale_dropped`` and gathered ring coming back; ``survivor_exact`` the
  blocking step's survivor-exact mean; ``dcn_ways`` K (with ``plan``, a
  plan name) the two-tier step over ``MeshSpec.from_world(N, K)``'s groups,
  its draws a dict of ``inner`` and ``outer`` parts; ``per_step`` returns rank 0's state
  after every step; every run returns the optimizer
  state as full flat vectors (the partitions' slices gathered);
* ``build``: the data-parallel step's factory on a registry model with
  given arguments (``dcn_ways``: over the two-tier mesh, given as
  ``mesh=``); the message of the ``ValueError`` it raises, or None;
  ``partition_build`` likewise over a partitioned state;
  ``partition_layout``: a partitioned state's flat layout from given weights;
  ``partition_host`` and ``partition_reshard``: a sharded state gathered on
  one world and resharded onto another; ``reshard_lm``: an LM's live
  reshard between model-axis layouts;
* ``aggregate``: the exchange alone (gather's decode-mean against the
  ring's) on payloads each rank encodes from given gradients;
  ``two_tier``: each plan's two-level mean on the two-tier mesh, executed
  (fused and unfused outer decode) and by the canonical oracle;
* ``cli``: ``atomo_tpu_torch train`` (or ``lm``) with the given
  arguments, its log lines and the messages of the warnings it raised;
* ``lm``: the port's LM steps on a (world / n_sp, n_sp) mesh
  (``launch.dp_sp_mesh``) from given weights, global token batches and
  per-rank codec draws; every rank returns each step's metrics and a hash
  of its parameters, rank 0 its final parameters. ``grads_only`` returns
  instead the gradient the optimizer receives at the first step;
  ``resume_at`` cuts the run as ``train``'s does;
* ``attention``: an sp attention function alone on this rank's shard of
  given (B, H, S, D) q, k, v, forward and backward against a given
  cotangent;
* ``mesh``: this rank's place in a dp x sp mesh and its groups' ranks;
* ``targets``, ``collectives``: the shard-boundary targets, one ring hop
  and one all-to-all over an sp axis of the whole world;
* ``modules``: the top-level modules loaded in the worker;
* ``layout``: the port's steps of an LM model-axis layout from a full JAX
  family tree (with ``resume_at``: cut there, checkpointed, loaded and
  continued), each step's metrics and slice hash, rank 0's gathered tree;
* ``mesh_spec``, ``model_collectives``: a built ``MeshSpec``'s place and
  groups, and the model-axis collectives forward and backward.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import select
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------- test side


class Group:
    """N worker processes in one gloo group; :meth:`run` sends a job to all."""

    def __init__(self, world: int, tmp: Path, timeout: float = 240.0):
        self.world = world
        self.timeout = timeout
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT)] + [
                       p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        store = tmp / f"store{world}"
        self.logs = [tmp / f"rank{r}of{world}.log" for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "wb") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__)), str(r), str(world), str(store)],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, env=env,
                    cwd=str(ROOT)))

    def run(self, fn: str, per_rank=None, **shared):
        """Run job ``fn`` on every rank with ``shared`` arguments (and
        ``per_rank[r]`` on rank r); returns the ranks' answers in rank order.
        A job that raised on any rank raises here with its traceback."""
        for r, p in enumerate(self.procs):
            args = dict(shared, **(per_rank[r] if per_rank is not None else {}))
            _write(p.stdin, (fn, args))
        deadline = time.monotonic() + self.timeout
        out = [self._read(p, r, deadline) for r, p in enumerate(self.procs)]
        errors = [o[1] for o in out if o[0] == "error"]
        if errors:
            raise AssertionError(f"job {fn} failed on a rank:\n{errors[0]}")
        return [o[1] for o in out]

    def _read(self, p, rank, deadline):
        fd = p.stdout.fileno()
        head = _read_exact(fd, 8, deadline, self, rank)
        return pickle.loads(_read_exact(fd, struct.unpack("<Q", head)[0], deadline, self,
                                        rank))

    def log_tail(self, rank: int) -> str:
        return self.logs[rank].read_text(errors="replace")[-4000:]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    _write(p.stdin, ("exit", {}))
                except (BrokenPipeError, OSError):
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
            assert p.poll() is not None


class Groups:
    """Gloo groups by world size, each started at its first use, so that a
    file whose cases need one size starts that group alone."""

    def __init__(self, tmp_path_factory, prefix: str, timeout: float = 240.0):
        self._tmp, self._prefix, self._timeout = tmp_path_factory, prefix, timeout
        self._groups: dict = {}

    def __getitem__(self, world: int) -> Group:
        if world not in self._groups:
            self._groups[world] = Group(world, self._tmp.mktemp(f"{self._prefix}{world}"),
                                        self._timeout)
        return self._groups[world]

    def close(self):
        for g in self._groups.values():
            g.close()


def _write(f, obj) -> None:
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _read_exact(fd: int, n: int, deadline: float, group=None, rank=0) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        left = deadline - time.monotonic()
        ready, _, _ = select.select([fd], [], [], max(left, 0.0))
        if not ready:
            raise TimeoutError(f"rank {rank} gave no answer in time; its log:\n"
                               f"{group.log_tail(rank) if group else ''}")
        chunk = os.read(fd, n - len(buf))
        if not chunk:
            raise EOFError(f"rank {rank} exited; its log:\n"
                           f"{group.log_tail(rank) if group else ''}")
        buf += chunk
    return bytes(buf)


# ------------------------------------------------------------- worker side


def _t(a):
    import torch

    return torch.from_numpy(a.copy()) if a is not None else None


def _draws(d):
    """Numpy draws (per leaf an array, or a dict of arrays) as tensors; a
    two-tier step's ``{"inner": ..., "outer": ...}`` by part."""
    if d is None:
        return None
    if isinstance(d, dict):
        return {k: _draws(v) for k, v in d.items()}
    return [{k: _t(v) for k, v in x.items()} if isinstance(x, dict) else _t(x) for x in d]


def _codec(spec):
    from atomo_tpu_torch.codecs import get_codec

    if spec is None:
        return None
    name, kw = spec
    return get_codec(name, **kw)


def build_model(network, num_classes: int, image_shape):
    """The port's model: a registry name, or ``(class name, kwargs)`` of
    ``atomo_tpu_torch.models`` (a reduced VGG or DenseNet)."""
    import atomo_tpu_torch.models as pm

    if isinstance(network, str):
        return pm.get_model(network, num_classes, image_shape=image_shape)
    name, kw = network
    return getattr(pm, name)(num_classes=num_classes, image_shape=image_shape, **kw)


def _masks(steps):
    """Per step the numpy keep-masks as tensors, or None."""
    return None if steps is None else [[_t(m) for m in ms] for ms in steps]


def state_hash(model) -> str:
    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def job_train(rank, world, *, network, num_classes, image_shape, state_dict, codec, aggregate,
              num_aggregate, ring_bucket_size, lr, momentum, batches, key, draws=None,
              dropout_masks=None, grad_accum=1, resume_at=0, train_dir=None, hybrid=None,
              budget_ks=None, error_feedback=False, parts=None, overlap="off",
              stream_encode=False, stream_bucket_bytes=4 << 20, bf16=False, guard=None,
              chaos=None, target_replica=0, track_quality=False, partition="replicated",
              optimizer=None, quorum=None, arrivals=None, survivor_exact=False,
              per_step=False, dcn_ways=0, plan=None):
    import dataclasses

    import torch.distributed as dist

    from atomo_tpu_torch.budget import budgeted_codec
    from atomo_tpu_torch.training import trainer as T

    import numpy as np

    import torch

    import atomo_tpu_torch.parallel.overlap as O
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.data import to_device
    from atomo_tpu_torch.data.pipeline import block_to_device
    from atomo_tpu_torch.parallel.overlap import carry_from_saved, gather_carry
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from atomo_tpu_torch.training.trainer import leaf_params

    masks = _masks(dropout_masks)

    def fresh():
        model = build_model(network, num_classes, image_shape)
        return model, TrainState(0, model, opt.init(leaf_params(model)))

    opt = (make_optimizer("sgd", lr=lr, momentum=momentum) if optimizer is None
           else make_optimizer(optimizer[0], **optimizer[1]))
    model, state = fresh()
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    state = R.replicate_state(state)
    from atomo_tpu_torch.mesh import update as U

    spec = None
    if partition == "zero1":
        state, spec = U.zero1_state(state, opt)
    elif partition == "sharded-update":
        state, spec = U.sharded_update_state(state, opt)
    assert not (spec is not None and resume_at), "partitions resume through the loop"
    scales = []
    encode = R.encode_tree

    def recording_encode(*args, **kw):  # the largest quantization step taken
        payloads, stats = encode(*args, **kw)
        for p in payloads:
            if hasattr(p, "scales"):
                scales.append(float(p.scales.max()))
        return payloads, stats

    encode_subset = R.encode_leaf_subset

    def recording_subset(*args, **kw):  # the hybrid's encode of its dense leaves
        payloads = encode_subset(*args, **kw)
        scales.extend(float(p.scales.max()) for p in payloads if hasattr(p, "scales"))
        return payloads

    import atomo_tpu_torch.topology.execute as TE

    R.encode_tree = recording_encode
    TE.encode_tree = recording_encode  # the two-tier encodes
    R.encode_leaf_subset = recording_subset
    O.encode_leaf_subset = recording_subset  # the bucket encodes of stream-encode

    def make_codec():
        c = _codec(codec)
        return c if budget_ks is None else budgeted_codec(c, budget_ks)

    def resilience():
        """The guard (its max grad norm, or None) and the chaos injector (a
        spec aimed at ``target_replica``)."""
        if guard is None:
            return {}
        from atomo_tpu_torch.training.resilience import GuardConfig
        from atomo_tpu_torch.utils.chaos import ChaosConfig, ChaosInjector

        cfg = dataclasses.replace(ChaosConfig.from_spec(chaos, environ={}),
                                  target_replica=target_replica)
        return dict(guard=GuardConfig(guard), chaos=ChaosInjector(cfg, membership_epoch=0))

    two_tier = {}
    if dcn_ways:  # the (dp=K, ici=N/K) mesh, its groups made once a job
        from atomo_tpu_torch.mesh.spec import MeshSpec
        from atomo_tpu_torch.topology import plan_from_name

        two_tier = dict(mesh=MeshSpec.from_world(world, dcn_ways).build(), inner_axis="ici",
                        plan=plan_from_name(plan) if plan is not None else None)

    def make_step(model, superstep=1):
        return R.make_distributed_train_step(
            model, opt, make_codec(), aggregate=aggregate, num_aggregate=num_aggregate,
            ring_bucket_size=ring_bucket_size, grad_accum=grad_accum, hybrid=hybrid,
            error_feedback=error_feedback, superstep=superstep, overlap=overlap,
            stream_encode=stream_encode, stream_bucket_bytes=stream_bucket_bytes,
            compute_dtype=torch.bfloat16 if bf16 else None, track_quality=track_quality,
            zero1=spec if partition == "zero1" else None,
            sharded_update=spec if partition == "sharded-update" else None,
            quorum=qcfg, survivor_exact=survivor_exact, **two_tier, **resilience())

    qcfg = None
    if quorum is not None:  # (Q, K): the quorum step, fed arrivals[s] at step s
        from atomo_tpu_torch.quorum import QuorumConfig

        qcfg = QuorumConfig(quorum[0], staleness=quorum[1])
        state = R.init_quorum_state(state, make_codec(), qcfg.staleness)
    delayed = overlap == "delayed"
    if delayed:
        state = R.init_delayed_state(state, make_codec())
    hash0 = state_hash(model)

    def record(m, j=None, last=True):
        if last and partition == "sharded-update":  # the parameters, from every master
            spec.materialize(state.master)

        def val(name, cast=float):
            if name not in m:
                return None
            return cast(m[name] if j is None or not hasattr(m[name], "shape") else m[name][j])

        def vec(name):  # a per-layer series: (L,) a step, (K, L) a block
            if name not in m:
                return None
            return [float(v) for v in (m[name] if j is None else m[name][j])]

        return {"loss": val("loss"), "prec1": val("prec1"), "prec5": val("prec5"),
                "msg_bytes": val("msg_bytes", int), "dense_bytes": val("dense_bytes", int),
                "hash": state_hash(model) if last else None,
                "row_overflow": val("row_overflow"), "ef_res_norm": val("ef_res_norm"),
                "skipped": val("skipped"), "dropped": val("dropped"),
                "quorum_kept": val("quorum_kept"), "stale_dropped": val("stale_dropped"),
                "ring": ({k: v.numpy().copy() for k, v in
                          R.gather_ring(state.ring, world).items()}
                         if last and qcfg is not None else None),
                # with per_step, rank 0's state after the step
                "state_dict": ({k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()}
                               if per_step and last and rank == 0 else None),
                "opt": _flat_opt(state, spec) if per_step and last and rank == 0 else None,
                "q_err2": vec("q_err2"), "q_rel": vec("q_rel"),
                "state_bytes": state_nbytes(state) if last else None}

    try:
        step = make_step(model)
        blocks = {}
        steps = []
        s = 0
        for k in parts or [1] * len(batches):
            if resume_at and s == resume_at:
                saved = state
                if error_feedback:
                    saved = dataclasses.replace(
                        state, residual=T.gather_residual(state, world))
                if delayed:
                    saved = dataclasses.replace(saved, carry=gather_carry(state.carry, world))
                if rank == 0:
                    save_checkpoint(train_dir, saved, compress=True)
                dist.barrier()
                model, state = fresh()
                state = load_checkpoint(train_dir, state)
                if error_feedback:
                    state = T.own_residual(state, model, rank, world, "cpu")
                if delayed:
                    saved_carry = state.carry
                    state = R.init_delayed_state(dataclasses.replace(state, carry=None),
                                                 make_codec())
                    carry, why = carry_from_saved(state.carry, saved_carry, rank, world)
                    assert why is None, why
                    state = dataclasses.replace(state, carry=carry)
                step = make_step(model)
                blocks = {}
            if k == 1:
                x, y = batches[s]
                xs, ys = R.shard_batch(x, y, rank, world)
                extra = () if qcfg is None else (arrivals[s],)
                state, m = step(state, key, *to_device(xs, ys, "cpu"), *extra,
                                draws=_draws(draws[s]) if draws is not None else None,
                                dropout_masks=masks[s] if masks is not None else None)
                steps.append(record(m))
            else:
                if k not in blocks:
                    blocks[k] = make_step(model, superstep=k)
                xs, ys = R.shard_superbatch(np.stack([b[0] for b in batches[s:s + k]]),
                                            np.stack([b[1] for b in batches[s:s + k]]),
                                            rank, world)
                staged = block_to_device(xs, ys, "cpu")
                state, m = blocks[k](
                    state, key, staged.images, staged.labels,
                    draws=[_draws(d) for d in draws[s:s + k]] if draws is not None else None,
                    dropout_masks=masks[s:s + k] if masks is not None else None)
                steps.extend(record(m, j, last=j == k - 1) for j in range(k))
            s += k
    finally:
        R.encode_tree = encode
        TE.encode_tree = encode
        R.encode_leaf_subset = encode_subset
        O.encode_leaf_subset = encode_subset
    final = ({k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
             if rank == 0 else None)
    return {"steps": steps, "state_dict": final, "max_scale": max(scales, default=0.0),
            "hash0": hash0, "opt": _flat_opt(state, spec), "count": state.opt_state.count}


def state_nbytes(state) -> int:
    """Bytes of a rank's persistent train state: the parameters (the master
    slice under the sharded update, whose working buffer is transient), the
    optimizer buffers and the statistics."""
    from atomo_tpu_torch.training.trainer import leaf_params, opt_buffers

    master = getattr(state, "master", None)
    params = leaf_params(state.model) if master is None else [master]
    tensors = params + opt_buffers(state.opt_state) + list(state.model.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)


def _flat_opt(state, spec):
    """The optimizer's buffers as full flat numpy vectors (canonical order,
    port layout, no padding), by field: a partition's slices gathered."""
    import dataclasses

    import torch

    out = {}
    for f in dataclasses.fields(state.opt_state):
        v = getattr(state.opt_state, f.name)
        if not isinstance(v, list):
            continue
        if spec is None:
            out[f.name] = torch.cat([t.reshape(-1) for t in v]).numpy().copy()
        else:
            out[f.name] = spec.gather(v[0])[:spec.d_flat].numpy().copy()
    return out


def job_build(rank, world, *, network, image_shape, codec, kwargs, dcn_ways=0):
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.training import make_optimizer

    model = build_model(network, 10, image_shape)
    if dcn_ways:  # the two-tier mesh over this world, given as mesh=
        from atomo_tpu_torch.mesh.spec import MeshSpec

        kwargs = dict(kwargs, mesh=MeshSpec.from_world(world, dcn_ways).build())
    try:
        R.make_distributed_train_step(model, make_optimizer("sgd"), _codec(codec), **kwargs)
    except ValueError as e:
        return str(e)
    return None


def job_partition_build(rank, world, *, network, image_shape, codec, partition, kwargs,
                        with_zero1=False):
    """The step factory over a partitioned state of a registry model (both
    specs with ``with_zero1``); the message of the ``ValueError`` it raises
    (the state's build included), or None."""
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.mesh import update as U
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    opt = make_optimizer("sgd", momentum=0.9)
    model = build_model(network, 10, image_shape)
    state = TrainState(0, model, opt.init(leaf_params(model)))
    try:
        build = U.zero1_state if partition == "zero1" else U.sharded_update_state
        _, spec = build(state, opt)
        kw = {"zero1" if partition == "zero1" else "sharded_update": spec}
        if with_zero1:
            kw["zero1"] = spec
        R.make_distributed_train_step(model, opt, _codec(codec), **kw, **kwargs)
    except ValueError as e:
        return str(e)
    return None


def job_partition_layout(rank, world, *, network, image_shape, state_dict, partition):
    """The flat layout of a partitioned state of a registry model from given
    weights: chunk, d_flat, the full flat parameter vector (the sharded
    update's masters gathered, ZeRO-1's persistent buffer) and the length of
    this rank's optimizer slice."""
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.mesh import update as U
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    opt = make_optimizer("sgd", momentum=0.9)
    model = build_model(network, 10, image_shape)
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    state = R.replicate_state(TrainState(0, model, opt.init(leaf_params(model))))
    if partition == "zero1":
        state, spec = U.zero1_state(state, opt)
        flat = spec.flat.clone()
    else:
        state, spec = U.sharded_update_state(state, opt)
        flat = spec.gather(state.master)
    return {"chunk": spec.chunk, "d_flat": spec.d_flat, "n": spec.n_shards,
            "flat": flat.numpy().copy(), "opt_len": state.opt_state.trace[0].numel()}


def _lenet_replicated(state_dict, image_shape):
    """(model, momentum SGD, qsgd 4 bits, the replicated state) of LeNet
    from given weights, in the group."""
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    model = build_model("lenet", 10, image_shape)
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    state = R.replicate_state(TrainState(0, model, opt.init(leaf_params(model))))
    return model, opt, get_codec("qsgd", quantization_level=4), state


def job_partition_host(rank, world, *, state_dict, image_shape, batches):
    """Sharded-update steps of LeNet on this world, then the gathered host
    state (``mesh.update.gather_host``) as numpy on rank 0."""
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.data import to_device
    from atomo_tpu_torch.mesh import update as U

    model, opt, codec, state = _lenet_replicated(state_dict, image_shape)
    state, spec = U.sharded_update_state(state, opt)
    step = R.make_distributed_train_step(model, opt, codec, sharded_update=spec)
    for x, y in batches:
        state, _ = step(state, 11, *to_device(*R.shard_batch(x, y, rank, world), "cpu"))
    host = U.gather_host(state, spec)
    if rank:
        return None
    return {"step": host["step"], "master": host["master"].numpy(),
            "opt": {"count": host["opt"]["count"],
                    "trace": [t.numpy() for t in host["opt"]["trace"]]}, "buffers": {}}


def _lenet_from_host(host, state_dict, image_shape):
    """A replicated LeNet state holding a gathered host state's parameters,
    momentum, count and step."""
    import dataclasses

    import torch

    from atomo_tpu_torch.training.trainer import leaf_params

    model, opt, codec, state = _lenet_replicated(state_dict, image_shape)
    params = leaf_params(model)
    d = sum(p.numel() for p in params)
    with torch.no_grad():
        for dst, src in ((params, host["master"]), (state.opt_state.trace,
                                                    host["opt"]["trace"][0])):
            at = 0
            for t in dst:
                t.copy_(src[at:at + t.numel()].view(t.shape))
                at += t.numel()
            assert at == d
    opt_state = dataclasses.replace(state.opt_state, count=host["opt"]["count"])
    return model, opt, codec, dataclasses.replace(state, step=host["step"], opt_state=opt_state)


def job_partition_reshard(rank, world, *, state_dict, image_shape, host, batches):
    """The host state of another world resharded onto this one
    (``mesh.reshard.reshard_sharded_update``) against a fresh sharded build
    from the same values (master and momentum slices, step, count), then
    stepped beside the replicated step from those values: per step, loss
    and parameters equal."""
    import torch

    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.data import to_device
    from atomo_tpu_torch.mesh import update as U
    from atomo_tpu_torch.mesh.reshard import reshard_sharded_update
    from atomo_tpu_torch.training.trainer import leaf_params

    host = {"step": host["step"], "master": _t(host["master"]),
            "opt": {"count": host["opt"]["count"], "trace": [_t(t) for t in host["opt"]["trace"]]},
            "buffers": {}}
    model, opt, codec, _ = _lenet_replicated(state_dict, image_shape)
    st, spec = reshard_sharded_update(host, model, opt)
    _, _, _, rep = _lenet_from_host(host, state_dict, image_shape)
    fresh, fspec = U.sharded_update_state(rep, opt)
    trace = host["opt"]["trace"][0][:spec.d_flat]
    padded = torch.nn.functional.pad(trace, (0, spec.n_shards * spec.chunk - spec.d_flat))
    slices = (torch.equal(st.master, fresh.master) and fspec.chunk == spec.chunk
              and torch.equal(st.opt_state.trace[0], spec.own(padded))
              and (st.step, st.opt_state.count) == (host["step"], host["opt"]["count"]))
    model3, _, _, rep3 = _lenet_from_host(host, state_dict, image_shape)
    s_step = R.make_distributed_train_step(model, opt, codec, sharded_update=spec)
    r_step = R.make_distributed_train_step(model3, opt, codec)
    same = []
    for x, y in batches:
        xs, ys = to_device(*R.shard_batch(x, y, rank, world), "cpu")
        st, ms = s_step(st, 11, xs, ys)
        rep3, mr = r_step(rep3, 11, xs, ys)
        spec.materialize(st.master)
        same.append(float(ms["loss"]) == float(mr["loss"]) and all(
            torch.equal(a, b) for a, b in zip(leaf_params(model), leaf_params(model3))))
    return {"slices": slices, "same": same, "chunk": spec.chunk, "n": spec.n_shards}


def job_reshard_lm(rank, world, *, cfg, codec):
    """``mesh.reshard.reshard_model_axes`` on a live LM: dp (world ranks)
    onto dp-tp (tp = world) and back, against a fresh build of the tp
    layout from the same values (momentum included), the round trip
    against the start; a delayed program's carry reset; dp-ep refused."""
    import dataclasses

    import numpy as np
    import torch

    import atomo_tpu_torch.parallel.lm as L
    from atomo_tpu_torch.convert import tree_leaves
    from atomo_tpu_torch.mesh.reshard import reshard_model_axes
    from atomo_tpu_torch.mesh.spec import MeshSpec
    from atomo_tpu_torch.parallel import model_axes as MA
    from atomo_tpu_torch.parallel.tp import lm_params_to_tp
    from atomo_tpu_torch.training import make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    c = _codec(codec)
    spec_dp = MeshSpec.from_layout("dp", world)
    spec_tp = MeshSpec.from_layout("dp-tp", world, world)
    prog = MA.build_model_axis_program(spec_dp, cfg, opt, 0, c, device="cpu")
    with torch.no_grad():  # non-trivial momentum, a step counter and a count
        for t, p in zip(prog.state.opt_state.trace, leaf_params(prog.state.model)):
            t.copy_(p * 0.5)
    prog = prog._replace(state=dataclasses.replace(
        prog.state, step=3, opt_state=dataclasses.replace(prog.state.opt_state, count=3)))
    tp = reshard_model_axes(prog, spec_tp, cfg, opt, codec=c)
    # the oracle: the bijection by hand and a fresh build of the tp layout
    from atomo_tpu_torch.convert import jax_from_state_dict

    params = lm_params_to_tp(jax_from_state_dict(prog.state.model)[0], cfg["num_heads"])
    fresh = MA.build_model_axis_program(spec_tp, cfg, opt, 0, c, layout="dp-tp", params=params,
                                        device="cpu")
    mom = lm_params_to_tp(jax_from_state_dict(prog.state.model, {
        k: 0.5 * v for k, v in prog.state.model.state_dict().items()})[0], cfg["num_heads"])
    want_mom = MA.slice_leaves([torch.from_numpy(x) for x in tree_leaves(mom)], fresh.splits,
                               fresh.mesh)
    tp_equal = (all(torch.equal(a, b) for a, b in zip(leaf_params(tp.state.model),
                                                      leaf_params(fresh.state.model)))
                and all(torch.equal(a, b) for a, b in zip(tp.state.opt_state.trace, want_mom))
                and (tp.state.step, tp.state.opt_state.count) == (3, 3))
    back = reshard_model_axes(tp, spec_dp, cfg, opt, codec=c)
    round_trip = (all(torch.equal(a, b) for a, b in zip(leaf_params(back.state.model),
                                                        leaf_params(prog.state.model)))
                  and all(torch.equal(a, b) for a, b in zip(back.state.opt_state.trace,
                                                            prog.state.opt_state.trace)))
    out = {"tp_equal": tp_equal, "round_trip": round_trip, "splits": tp.splits is not None}
    ex = L.DpExchange("gather", overlap="delayed")
    dprog = MA.build_model_axis_program(spec_dp, cfg, opt, 0, c, exchange=ex, device="cpu")
    dprog = dprog._replace(state=dataclasses.replace(dprog.state, carry=dataclasses.replace(
        dprog.state.carry, valid=True)))
    try:
        reshard_model_axes(dprog, spec_tp, cfg, opt)
        out["no_codec"] = None
    except ValueError as e:
        out["no_codec"] = str(e)
    dtp = reshard_model_axes(dprog, spec_tp, cfg, opt, codec=c, exchange=ex)
    plain = reshard_model_axes(dprog._replace(state=dataclasses.replace(dprog.state, carry=None)),
                               spec_tp, cfg, opt, codec=c)
    out["carry_reset"] = (not dtp.state.carry.valid and all(
        torch.equal(a, b) for a, b in zip(leaf_params(dtp.state.model),
                                          leaf_params(plain.state.model))))
    try:
        reshard_model_axes(prog, MeshSpec.from_layout("dp-ep", world, world), cfg, opt, codec=c)
        out["ep"] = None
    except ValueError as e:
        out["ep"] = str(e)
    out["loss_finite"] = bool(np.isfinite(float(tp.step(
        tp.state, 5, torch.from_numpy(np.ascontiguousarray(tp.shard_tokens(
            np.arange(4 * cfg["max_len"]).reshape(4, -1) % cfg["vocab_size"]))).long())[1]["loss"])))
    return out


def job_aggregate(rank, world, *, codec, grads, draws, fused_gather, ring_bucket_size,
                  num_aggregate=0, step=0):
    """Gather's decode-mean and the ring's on the same payloads: this rank's
    (numpy, port layout) gradients encoded with its draws."""
    import numpy as np

    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.codecs import decode_mean_tree, encode_tree
    from atomo_tpu_torch.parallel.common import unpack_tree_buckets

    c = _codec(codec)
    gs = [_t(g) for g in grads]
    payloads, _ = encode_tree(c, 0, gs, _draws(draws))
    k = num_aggregate if 0 < num_aggregate < world else 0
    start = step % world if k else None
    gathered, spec = R.gather_payloads(payloads, world)
    if k:
        gathered = R._rotating_rows(gathered, start, k)
    mean_g = decode_mean_tree(c, unpack_tree_buckets(gathered, spec), gs, k or world,
                              fused=fused_gather)
    mean_r = R.ring_stream_mean(c, payloads, gs, rank=rank, world=world, sel_start=start,
                                n_contrib=k or world, ring_bucket_size=ring_bucket_size)
    return {"gather": [m.numpy().copy() for m in mean_g],
            "ring": [m.numpy().copy() for m in mean_r],
            "equal": all(bool(np.array_equal(a.numpy(), b.numpy()))
                         for a, b in zip(mean_g, mean_r))}


def job_two_tier(rank, world, *, codec, grads, dcn_ways, plans, step_key):
    """Each plan's two-level mean on this rank of the two-tier mesh (this
    rank's numpy gradients in the JAX layout, its own draws under the
    step's keys): the executed operator with the unfused outer decode, the
    canonical oracle over the same groups, and the executed operator as the
    step runs it (fused decode). Numpy, by plan name."""
    from atomo_tpu_torch.mesh.spec import MeshSpec
    from atomo_tpu_torch.topology import execute as TE
    from atomo_tpu_torch.topology.schedule import plan_from_name

    mesh = MeshSpec.from_world(world, dcn_ways).build()
    c = _codec(codec)
    gs = [_t(g) for g in grads]
    lay = [False] * len(gs)
    k_in = TE.inner_codec_key(step_key, rank)
    k_out = TE.outer_codec_key(step_key, mesh.index("dp"))
    out = {}
    for name in plans:
        plan = plan_from_name(name)
        kw = dict(mesh=mesh, layouts=lay)
        unfused = TE.planned_two_level_mean(c, plan, gs, k_in, k_out, unfused_decode=True,
                                            **kw)[0]
        fused = TE.planned_two_level_mean(c, plan, gs, k_in, k_out, **kw)[0]
        canon = TE.two_level_canonical_mean(c, plan, gs, k_in, k_out, device="cpu", **kw)
        out[name] = {k: [m.numpy().copy() for m in v] for k, v in
                     (("unfused", unfused), ("fused", fused), ("canonical", canon))}
    return out


def job_cli(rank, world, *, argv, env=None):
    """The CLI with ``argv`` (``env`` set in the environment around it)."""
    import warnings

    from atomo_tpu_torch import cli

    lines = []
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                rc = cli.main(list(argv), log_fn=lines.append)
            except SystemExit as e:  # the CLI's refusals: their message, not the worker's exit
                return {"rc": 1, "lines": lines, "exit": str(e.code),
                        "warnings": [str(w.message) for w in caught]}
        return {"rc": rc, "lines": lines, "exit": None,
                "warnings": [str(w.message) for w in caught]}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Recorder:
    """An optimizer that keeps the gradient it is handed and changes
    nothing: what the LM step's dp tail delivers."""

    def __init__(self):
        self.grads = None

    def init(self, params):
        from atomo_tpu_torch.training import make_optimizer

        return make_optimizer("sgd").init(params)

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        return state


def job_lm(rank, world, *, n_sp, cfg, state_dict, codec, attn_impl, aggregate, optimizer,
           batches, keys, draws=None, bf16=False, resume_at=0, train_dir=None,
           grads_only=False, modes=None):
    import torch

    import atomo_tpu_torch.parallel.lm as L
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    mesh = launch.dp_sp_mesh(n_sp)
    opt = _Recorder() if grads_only else make_optimizer(optimizer[0], **optimizer[1])
    scales = []

    def fresh():
        model = TransformerLM(**cfg)
        model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
        state = TrainState(0, model, opt.init(leaf_params(model)))
        c = _codec(codec)
        step = L.make_lm_train_step(
            model, opt, c, attn_impl=attn_impl, aggregate=aggregate, mesh=mesh,
            exchange=(L.DpExchange(aggregate, **modes) if aggregate == "ring" or modes
                      else None),
            compute_dtype=torch.bfloat16 if bf16 else None)
        if (modes or {}).get("overlap") == "delayed":
            state = L.init_model_axis_delayed_state(state, c)
        return model, state, step

    import atomo_tpu_torch.parallel.overlap as O

    modes = modes or {}
    encode, subset = L.encode_tree, O.encode_leaf_subset
    streamed = L.encode_tree_streamed

    def recording_encode(*args, **kw):  # the largest quantization step taken
        payloads, stats = encode(*args, **kw)
        scales.extend(float(p.scales.max()) for p in payloads if hasattr(p, "scales"))
        return payloads, stats

    def recording_streamed(*args, **kw):
        payloads, stats = streamed(*args, **kw)
        scales.extend(float(p.scales.max()) for p in payloads if hasattr(p, "scales"))
        return payloads, stats

    def recording_subset(*args, **kw):  # the bucket encodes of stream-encode
        payloads = subset(*args, **kw)
        scales.extend(float(p.scales.max()) for p in payloads if hasattr(p, "scales"))
        return payloads

    L.encode_tree, L.encode_tree_streamed = recording_encode, recording_streamed
    O.encode_leaf_subset = recording_subset
    try:
        return _lm_steps(rank, fresh, batches, keys, draws, mesh, opt, grads_only, resume_at,
                         train_dir, scales)
    finally:
        L.encode_tree, L.encode_tree_streamed, O.encode_leaf_subset = encode, streamed, subset


def _lm_steps(rank, fresh, batches, keys, draws, mesh, opt, grads_only, resume_at, train_dir,
              scales):
    import torch
    import torch.distributed as dist

    from atomo_tpu_torch.parallel.lm import shard_tokens
    from atomo_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

    model, state, step = fresh()
    hash0 = state_hash(model)
    steps = []
    for s, (tokens, key) in enumerate(zip(batches, keys)):
        if resume_at and s == resume_at:
            if rank == 0:
                save_checkpoint(train_dir, state, compress=True)
            dist.barrier()
            model, state, step = fresh()
            state = load_checkpoint(train_dir, state)
        block = torch.from_numpy(shard_tokens(tokens, mesh).copy()).long()
        state, m = step(state, key, block, draws=_draws(draws[s]) if draws else None)
        if grads_only:
            return {"grads": [g.numpy().copy() for g in opt.grads], "loss": float(m["loss"])}
        steps.append({"loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"]),
                      "dense_bytes": int(m["dense_bytes"]), "hash": state_hash(model),
                      "skipped": float(m["skipped"]) if "skipped" in m else None})
    final = ({k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
             if rank == 0 else None)
    return {"steps": steps, "state_dict": final, "max_scale": max(scales, default=0.0),
            "mesh": (mesh.rank_dp, mesh.rank_sp), "step": state.step, "hash0": hash0}


def job_layout(rank, world, *, layout, ways, cfg, params, codec, aggregate, microbatches,
               attn_impl, optimizer, batches, keys, draws=None, bf16=False, modes=None,
               resume_at=0, train_dir=None):
    """The port's steps of an LM layout (``build_model_axis_program``) on
    this rank, from the full tree ``params`` (numpy, the JAX layout); with
    ``resume_at`` the run is cut there (rank 0 saves the gathered tree, every
    rank loads it into a fresh program and goes on). Per step the loss, the
    message and dense bytes and a hash of this rank's slice; every rank's
    slice coordinates, and rank 0's gathered full tree at the end."""
    import numpy as np
    import torch

    import atomo_tpu_torch.parallel.lm as L
    from atomo_tpu_torch.mesh.spec import MeshSpec
    from atomo_tpu_torch.parallel import model_axes as MA
    from atomo_tpu_torch.training import make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    scales = []
    encode = L.encode_tree

    def recording_encode(*args, **kw):  # the largest quantization step taken
        payloads, stats = encode(*args, **kw)
        scales.extend(float(p.scales.max()) for p in payloads if hasattr(p, "scales"))
        return payloads, stats

    modes = modes or {}
    spec = MeshSpec.from_layout(layout, world, tuple(ways) if layout == "dp-tp-sp" else ways)

    def fresh():
        opt = make_optimizer(optimizer[0], **optimizer[1])
        prog = MA.build_model_axis_program(
            spec, cfg, opt, 0, _codec(codec), layout=layout, attn_impl=attn_impl,
            num_microbatches=microbatches, aggregate=aggregate,
            exchange=(L.DpExchange(aggregate, **modes) if aggregate == "ring" or modes
                      else None),
            compute_dtype=torch.bfloat16 if bf16 else None, params=params, device="cpu")
        return prog, opt

    L.encode_tree = recording_encode
    try:
        prog, opt = fresh()
        state, steps = prog.state, []
        for s, (tokens, key) in enumerate(zip(batches, keys)):
            if resume_at and s == resume_at:
                MA.save_program_checkpoint(prog, state, train_dir, compress=True)
                prog, opt = fresh()
                state, _ = MA.load_program_checkpoint(prog, train_dir)
            block = torch.from_numpy(np.ascontiguousarray(prog.shard_tokens(tokens))).long()
            state, m = prog.step(state, key, block, draws=_draws(draws[s]) if draws else None)
            steps.append({"loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"]),
                          "dense_bytes": int(m["dense_bytes"]), "hash": state_hash(state.model),
                          "skipped": float(m["skipped"]) if "skipped" in m else None})
        full = MA.gather_leaves(leaf_params(state.model), prog.splits, prog.mesh)
    finally:
        L.encode_tree = encode
    from atomo_tpu_torch.convert import jax_leaf_order, to_numpy_tree

    tree = to_numpy_tree(MA.tree_of(jax_leaf_order(state.model), full))
    coords = tuple(prog.mesh.index(a) for a, _ in spec.model_axes)
    return {"steps": steps, "full": tree if rank == 0 else None, "slice": coords,
            "max_scale": max(scales, default=0.0), "step": state.step}


def job_attention(rank, world, *, impl, q, k, v, cotangent, causal=True):
    """``ATTENTION_IMPLS[impl]`` over an sp axis of the whole world on this
    rank's sequence shard: its output block and its q, k, v gradients."""
    import torch

    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.ring import ATTENTION_IMPLS

    mesh = launch.dp_sp_mesh(world)
    s = q.shape[2] // world
    part = [torch.from_numpy(a[:, :, rank * s:(rank + 1) * s].copy()).requires_grad_()
            for a in (q, k, v)]
    out = ATTENTION_IMPLS[impl](*part, axis_name="sp", axis_size=world, causal=causal,
                                group=mesh.sp_group)
    (out * torch.from_numpy(cotangent[:, :, rank * s:(rank + 1) * s].copy())).sum().backward()
    return {"out": out.detach().numpy(), "grads": [t.grad.numpy() for t in part]}


def job_mesh(rank, world, *, n_sp):
    import torch.distributed as dist

    from atomo_tpu_torch.parallel import launch

    mesh = launch.dp_sp_mesh(n_sp)
    return {"position": (mesh.rank_dp, mesh.rank_sp), "describe": mesh.describe(),
            "dp": dist.get_process_group_ranks(mesh.dp_group),
            "sp": dist.get_process_group_ranks(mesh.sp_group)}


def job_targets(rank, world, *, tokens):
    """``sp_boundary_targets_and_mask`` on this rank's sequence shard, over
    an sp axis of the whole world."""
    import torch

    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.lm import sp_boundary_targets_and_mask

    mesh = launch.dp_sp_mesh(world)
    s = tokens.shape[1] // world
    t, v = sp_boundary_targets_and_mask(
        torch.from_numpy(tokens[:, rank * s:(rank + 1) * s].copy()).long(), world,
        mesh.sp_group)
    return {"targets": t.numpy(), "valid": v.numpy()}


def job_collectives(rank, world):
    """One ring hop and one all-to-all over the whole world, each with a
    backward from a cotangent that names its rank."""
    import torch

    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.common import all_to_all, ring_hop

    group = launch.dp_sp_mesh(world).sp_group
    x = torch.tensor([float(rank)], requires_grad=True)
    y = ring_hop(x, group, world)
    y.backward(torch.tensor([10.0 * rank]))
    a = torch.tensor([10.0 * rank + i for i in range(world)], requires_grad=True)
    b = all_to_all(a, group, world)
    b.backward(torch.tensor([100.0 * rank + i for i in range(world)]))
    return {"hop": float(y), "hop_grad": float(x.grad), "a2a": b.tolist(),
            "a2a_grad": a.grad.tolist()}


def job_mesh_spec(rank, world, *, axes):
    """``MeshSpec(axes).build()`` on this rank: its coordinates and, per
    axis, the ranks of its group."""
    import torch.distributed as dist

    from atomo_tpu_torch.mesh.spec import MeshSpec

    m = MeshSpec(tuple(axes)).build()
    return {"coords": m.coords, "describe": m.spec.describe(),
            "groups": [dist.get_process_group_ranks(g) for g in m.groups]}


def job_model_collectives(rank, world):
    """Each model-axis collective over the whole world, forward and
    backward from a cotangent that names the rank."""
    import torch

    from atomo_tpu_torch.mesh import collectives as C
    from atomo_tpu_torch.parallel import launch

    group = launch.dp_sp_mesh(world).sp_group
    out = {}
    x = torch.tensor([float(rank)], requires_grad=True)
    y = C.pipeline_hop(x, group, world)
    y.backward(torch.tensor([10.0 * rank]))
    out["hop"], out["hop_grad"] = float(y), float(x.grad)
    x = torch.tensor([1.0 + rank], requires_grad=True)
    y = C.copy_to(x, group, world) * (rank + 1)
    y.backward()
    out["copy"], out["copy_grad"] = float(y), float(x.grad)
    x = torch.tensor([1.0 + rank], requires_grad=True)
    y = C.reduce_from(x, group, world) * (rank + 1)
    y.backward()
    out["reduce"], out["reduce_grad"] = float(y), float(x.grad)
    out["pmax"] = float(C.pmax(torch.tensor([float(rank)], requires_grad=True), group, world))
    out["psum"] = float(C.psum(torch.tensor([float(rank)]), group, world))
    a = (100.0 * rank + torch.arange(2.0 * world * 3).reshape(2, world, 3)).requires_grad_()
    b = C.all_to_all_tiled(a, group, world, split_axis=1, concat_axis=2)
    b.backward(torch.full_like(b, float(rank)) + torch.arange(float(b.numel())).view_as(b))
    out["a2a"], out["a2a_grad"] = b.detach().numpy(), a.grad.numpy()
    return out


def job_modules(rank, world):
    return sorted({m.split(".")[0] for m in sys.modules})


JOBS = {"train": job_train, "build": job_build, "partition_build": job_partition_build,
        "partition_layout": job_partition_layout, "partition_host": job_partition_host,
        "partition_reshard": job_partition_reshard, "reshard_lm": job_reshard_lm,
        "aggregate": job_aggregate, "two_tier": job_two_tier, "cli": job_cli,
        "lm": job_lm, "layout": job_layout, "attention": job_attention, "mesh": job_mesh,
        "targets": job_targets, "collectives": job_collectives, "modules": job_modules,
        "mesh_spec": job_mesh_spec, "model_collectives": job_model_collectives}


def main(argv) -> int:
    rank, world, store = int(argv[1]), int(argv[2]), argv[3]
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)  # stray prints go to the log, not into the answers
    inp = sys.stdin.buffer
    import torch

    torch.set_num_threads(1)
    from atomo_tpu_torch.parallel import launch

    launch.initialize("cpu", init_method=f"file://{store}", world_size=world, rank=rank,
                      init_timeout=120)
    import traceback

    try:
        while True:
            head = inp.read(8)
            if len(head) < 8:
                return 0
            fn, args = pickle.loads(inp.read(struct.unpack("<Q", head)[0]))
            if fn == "exit":
                return 0
            try:
                _write(out, ("ok", JOBS[fn](rank, world, **args)))
            except Exception:  # the boundary: report the job's failure, keep serving
                _write(out, ("error", f"rank {rank}:\n{traceback.format_exc()}"))
    finally:
        launch.shutdown()


if __name__ == "__main__":
    sys.exit(main(sys.argv))
