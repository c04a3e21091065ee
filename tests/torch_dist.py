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
  after a block's last step only (None inside a block);
* ``build``: the data-parallel step's factory on a registry model with
  given arguments; the message of the ``ValueError`` it raises, or None;
* ``aggregate``: the exchange alone (gather's decode-mean against the
  ring's) on payloads each rank encodes from given gradients;
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
    """Numpy draws (per leaf an array, or a dict of arrays) as tensors."""
    if d is None:
        return None
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
              stream_encode=False, stream_bucket_bytes=4 << 20, bf16=False):
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

    opt = make_optimizer("sgd", lr=lr, momentum=momentum)
    model, state = fresh()
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    state = R.replicate_state(state)
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

    R.encode_tree = recording_encode
    R.encode_leaf_subset = recording_subset
    O.encode_leaf_subset = recording_subset  # the bucket encodes of stream-encode

    def make_codec():
        c = _codec(codec)
        return c if budget_ks is None else budgeted_codec(c, budget_ks)

    def make_step(model, superstep=1):
        return R.make_distributed_train_step(
            model, opt, make_codec(), aggregate=aggregate, num_aggregate=num_aggregate,
            ring_bucket_size=ring_bucket_size, grad_accum=grad_accum, hybrid=hybrid,
            error_feedback=error_feedback, superstep=superstep, overlap=overlap,
            stream_encode=stream_encode, stream_bucket_bytes=stream_bucket_bytes,
            compute_dtype=torch.bfloat16 if bf16 else None)

    delayed = overlap == "delayed"
    if delayed:
        state = R.init_delayed_state(state, make_codec())
    hash0 = state_hash(model)

    def record(m, j=None, last=True):
        def val(name, cast=float):
            if name not in m:
                return None
            return cast(m[name] if j is None or not hasattr(m[name], "shape") else m[name][j])

        return {"loss": val("loss"), "prec1": val("prec1"), "prec5": val("prec5"),
                "msg_bytes": val("msg_bytes", int), "dense_bytes": val("dense_bytes", int),
                "hash": state_hash(model) if last else None,
                "row_overflow": val("row_overflow"), "ef_res_norm": val("ef_res_norm"),
                "skipped": val("skipped")}

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
                state, m = step(state, key, *to_device(xs, ys, "cpu"),
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
        R.encode_leaf_subset = encode_subset
        O.encode_leaf_subset = encode_subset
    final = ({k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
             if rank == 0 else None)
    return {"steps": steps, "state_dict": final, "max_scale": max(scales, default=0.0),
            "hash0": hash0}


def job_build(rank, world, *, network, image_shape, codec, kwargs):
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.training import make_optimizer

    model = build_model(network, 10, image_shape)
    try:
        R.make_distributed_train_step(model, make_optimizer("sgd"), _codec(codec), **kwargs)
    except ValueError as e:
        return str(e)
    return None


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


JOBS = {"train": job_train, "build": job_build, "aggregate": job_aggregate, "cli": job_cli,
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
