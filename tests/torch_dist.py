"""A gloo process group of the port for the multi-rank tests, and its worker.

:class:`Group` starts N worker processes on the CPU (this file run as a
script), which bring up one gloo group through a ``file://`` store and then
run jobs until they are closed: each job goes to every rank, and each rank's
answer comes back. The workers import torch and the port only, never JAX;
the test process computes the JAX package's side and hands the workers
numpy arrays. One group serves all the cases of a test file (a
module-scoped fixture), so the start-up is paid once a file.

Jobs (``JOBS``):

* ``train``: the port's data-parallel steps from given weights, batches and
  per-rank codec draws; every rank returns each step's metrics and a hash of
  its parameters and buffers, rank 0 its final state;
* ``aggregate``: the exchange alone (gather's decode-mean against the
  ring's) on payloads each rank encodes from given gradients;
* ``cli``: ``atomo_tpu_torch train`` with the given arguments, its log
  lines.
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


def state_hash(model) -> str:
    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def job_train(rank, world, *, network, num_classes, image_shape, state_dict, codec, aggregate,
              num_aggregate, ring_bucket_size, lr, momentum, batches, key, draws=None):
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.data import to_device
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    model = get_model(network, num_classes, image_shape=image_shape)
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    opt = make_optimizer("sgd", lr=lr, momentum=momentum)
    state = R.replicate_state(TrainState(0, model, opt.init(leaf_params(model))))
    scales = []
    encode = R.encode_tree

    def recording_encode(*args, **kw):  # the largest quantization step taken
        payloads, stats = encode(*args, **kw)
        for p in payloads:
            if hasattr(p, "scales"):
                scales.append(float(p.scales.max()))
        return payloads, stats

    R.encode_tree = recording_encode
    try:
        step = R.make_distributed_train_step(
            model, opt, _codec(codec), aggregate=aggregate, num_aggregate=num_aggregate,
            ring_bucket_size=ring_bucket_size)
        steps = []
        for s, (x, y) in enumerate(batches):
            xs, ys = R.shard_batch(x, y, rank, world)
            state, m = step(state, key, *to_device(xs, ys, "cpu"),
                            draws=_draws(draws[s]) if draws is not None else None)
            steps.append({"loss": float(m["loss"]), "prec1": float(m["prec1"]),
                          "prec5": float(m["prec5"]), "msg_bytes": int(m["msg_bytes"]),
                          "dense_bytes": int(m["dense_bytes"]), "hash": state_hash(model)})
    finally:
        R.encode_tree = encode
    final = ({k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
             if rank == 0 else None)
    return {"steps": steps, "state_dict": final, "max_scale": max(scales, default=0.0)}


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


def job_cli(rank, world, *, argv):
    from atomo_tpu_torch import cli

    lines = []
    try:
        rc = cli.main(list(argv), log_fn=lines.append)
    except SystemExit as e:  # the CLI's refusals: their message, not the worker's exit
        return {"rc": 1, "lines": lines, "exit": str(e.code)}
    return {"rc": rc, "lines": lines, "exit": None}


JOBS = {"train": job_train, "aggregate": job_aggregate, "cli": job_cli}


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
