"""Resume of the port, bit for bit, and the evaluator's numbers.

* One device (the CPU): LeNet 6 steps straight, and 3 steps then
  ``resume`` to 6, for sgd, qsgd 4 bits and svd rank 3, momentum 0.9: every
  parameter, buffer and optimizer tensor of the two runs equal bit for bit
  (the data stream skips the batches already taken, the step keys fold the
  restored step, the schedule reads the restored count). The resumed run
  logs ``Resumed from D at step 3`` and goes on at step 4.
* N = 2 gloo ranks (:mod:`torch_dist`): the CLI's data-parallel loop
  straight and resumed, bit for bit; and the data-parallel qsgd gather step
  from the JAX package's init with its draws, cut after step 3 (rank 0
  saves, every rank loads the file into a fresh model), equal to the
  uncut N = 2 run bit for bit and to the JAX package's dp-2 run at the
  tolerances of ``tests/test_torch_dist_gather.py``
  (``torch_dist_jax.assert_parity``).
* The CLI on the CPU: ``train`` saving every 3 steps, ``train --resume``
  to 9, then ``evaluate``: one ``Evaluator:`` line per checkpoint, each with
  the numbers of the trainer's ``Validation:`` line at that step.
"""

import re

import pytest
import torch
import torch_dist_jax as J
from torch_dist import Group

from atomo_tpu_torch import cli
from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import make_optimizer, train_loop
from atomo_tpu_torch.training.checkpoint import load_checkpoint
from atomo_tpu_torch.training.trainer import create_state

CODECS = {"sgd": None, "qsgd": ("qsgd", {"quantization_level": 4}),
          "svd": ("svd", {"svd_rank": 3})}


def _run(train_dir, max_steps, code, resume=False):
    logs = []
    ds = synthetic_dataset(SPECS["mnist"], True, size=96, seed=2)
    spec = CODECS[code]
    state = train_loop(
        get_model("lenet", 10), make_optimizer("sgd", lr=0.01, momentum=0.9),
        BatchIterator(ds, 16, seed=2), codec=get_codec(spec[0], **spec[1]) if spec else None,
        max_steps=max_steps, seed=2, train_dir=str(train_dir), save_freq=3, resume=resume,
        log_fn=logs.append, log_every=1, device="cpu")
    return state, logs


def _assert_bitwise(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    for x, y in zip(a.opt_state.trace, b.opt_state.trace):
        assert torch.equal(x, y)


@pytest.mark.parametrize("code", sorted(CODECS))
def test_resume_is_bit_identical(tmp_path, code):
    straight, _ = _run(tmp_path / "a", 6, code)
    _run(tmp_path / "b", 3, code)
    resumed, logs = _run(tmp_path / "b", 6, code, resume=True)
    assert logs[0] == f"Resumed from {tmp_path / 'b'} at step 3"
    assert logs[1].startswith("Worker: 0, Step: 4,")
    _assert_bitwise(resumed, straight)


def test_resume_of_an_all_corrupt_directory_starts_fresh(tmp_path):
    _run(tmp_path, 3, "sgd")
    (tmp_path / "model_step_3").write_bytes(b"APT1 torn")
    with pytest.warns(UserWarning, match="skipping invalid checkpoint"):
        state, logs = _run(tmp_path, 4, "sgd", resume=True)
    assert logs[0].startswith("Resume requested but no VALID model_step_N checkpoints in ")
    assert logs[0].endswith("; starting fresh")
    assert logs[1].startswith("Worker: 0, Step: 1,") and state.step == 4


# ------------------------------------------------------------ two gloo ranks

DIST_FLAGS = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
              "--batch-size", "16", "--log-interval", "1", "--eval-freq", "0",
              "--n-devices", "2", "--code", "qsgd", "--save-freq", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


def _loaded(train_dir, step):
    state = create_state(get_model("lenet", 10), make_optimizer("sgd", lr=0.01, momentum=0.5),
                         0, "cpu")
    return load_checkpoint(str(train_dir), state, step)


def test_dist_cli_resume_is_bit_identical(group, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for argv in (["--max-steps", "6", "--train-dir", str(a)],
                 ["--max-steps", "3", "--train-dir", str(b)],
                 ["--max-steps", "6", "--train-dir", str(b), "--resume"]):
        answers = group.run("cli", argv=DIST_FLAGS + argv)
        assert [x["rc"] for x in answers] == [0, 0], answers
    lines = answers[0]["lines"]
    assert lines[0] == f"Resumed from {b} at step 3" and answers[1]["lines"] == []
    assert lines[1].startswith("Worker: 0, Step: 4,")
    _assert_bitwise(_loaded(b, 6), _loaded(a, 6))


def test_dist_resume_matches_jax(group, tmp_path):
    ref = J.Reference("lenet", "mnist", 16, 6)
    out, draws = ref.run("qsgd", "gather", 2)
    per_rank = [{"draws": d} for d in draws]
    straight = group.run("train", per_rank=per_rank, **ref.job("qsgd", "gather"))
    resumed = group.run("train", per_rank=per_rank, **ref.job("qsgd", "gather"),
                        resume_at=3, train_dir=str(tmp_path))
    assert [s["hash"] for s in resumed[0]["steps"]] == [s["hash"] for s in straight[0]["steps"]]
    J.assert_parity(ref, out, resumed, "qsgd")


# ---------------------------------------------------------------- the CLI


def test_cli_train_resume_evaluate(tmp_path):
    flags = ["--device", "cpu", "--network", "LeNet", "--synthetic"]
    train = ["train", *flags, "--save-freq", "3", "--eval-freq", "3", "--log-interval", "1",
             "--train-dir", str(tmp_path)]
    lines = []
    assert cli.main(train + ["--max-steps", "6"], log_fn=lines.append) == 0
    resumed = []
    assert cli.main(train + ["--max-steps", "9", "--resume"], log_fn=resumed.append) == 0
    assert resumed[0] == f"Resumed from {tmp_path} at step 6"
    assert resumed[1].startswith("Worker: 0, Step: 7,")
    evals = []
    assert cli.main(["evaluate", *flags, "--model-dir", str(tmp_path), "--max-polls", "1",
                     "--stop-when-idle"], log_fn=evals.append) == 0
    validation = [ln for ln in lines + resumed if ln.startswith("Validation: ")]
    assert [int(re.search(r"Step: (\d+)", ln)[1]) for ln in validation] == [3, 6, 9]
    assert evals == [ln.replace("Validation: ", "Evaluator: ") for ln in validation]
