"""The partitions through the data-parallel loop and the CLI over gloo
ranks, their resume matrix, and the two reshard functions.

``train --partition sharded-update`` over two ranks prints the JAX verb's
``Worker:`` Msg(MB), and its checkpoints resume bit for bit: cut at 2 and
resumed to 4 it writes the straight run's ``model_step_4`` byte for byte,
whose master holds the replicated run's parameters. Under ``--overlap
delayed`` the checkpoint carries the in-flight payload: a run killed by
``--chaos kill@5`` (both ranks exit 43) and resumed equals the straight run
byte for byte. A replicated checkpoint resumed into either partition keeps
its parameters, re-initializes the sharded momentum and warns with the JAX
loop's text; ``--zero1 --overlap delayed --resume`` is refused with it. One
process without a group warns as the JAX verb and trains the replicated
update. ``reshard_sharded_update`` moves a 3-rank state onto 2 ranks with
the master and momentum re-sliced exactly (a fresh build's), and the
resharded run goes on with the replicated step's parameters bit for bit;
``reshard_model_axes`` moves a live LM from dp onto dp-tp equal to a fresh
build (momentum included) and back to the start exactly, resets a delayed
carry, and refuses dp-ep as the JAX package does.
"""

import os
import subprocess
import sys
import warnings

import pytest
import torch
import torch_dist_jax as J
from torch_dist import ROOT, Groups

from atomo_tpu_torch import cli
from atomo_tpu_torch.convert import jax_leaf_order
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training.checkpoint import read_checkpoint
from atomo_tpu_torch.training.trainer import init_params

ARGV = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--batch-size",
        "16", "--log-interval", "1", "--eval-freq", "0", "--code", "qsgd", "--n-devices", "2",
        "--aggregate", "gather", "--momentum", "0.9", "--save-freq", "2"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = Groups(tmp_path_factory, "gloo_part_cli")
    yield g
    g.close()


def cli_run(group, argv, **env):
    out = group.run("cli", argv=argv + ["--device", "cpu"], env=env or None)
    assert [a["rc"] for a in out] == [0, 0], out[0]
    return out


def msgs(lines):
    return [ln.split("Msg(MB):")[1].split(",")[0].strip() for ln in lines
            if ln.startswith("Worker:")]


def test_cli_sharded_update_trains_and_resumes(groups, tmp_path, capsys):
    from atomo_tpu import cli as jax_cli

    g = groups[2]
    straight = cli_run(g, ARGV + ["--max-steps", "4", "--partition", "sharded-update",
                                  "--train-dir", str(tmp_path / "s")])
    cli_run(g, ARGV + ["--max-steps", "2", "--partition", "sharded-update",
                       "--train-dir", str(tmp_path / "c")])
    resumed = cli_run(g, ARGV + ["--max-steps", "4", "--partition", "sharded-update",
                                 "--train-dir", str(tmp_path / "c"), "--resume"])
    rep = cli_run(g, ARGV + ["--max-steps", "4", "--train-dir", str(tmp_path / "r")])
    assert f"Resumed from {tmp_path / 'c'} at step 2" in resumed[0]["lines"]
    assert ((tmp_path / "s" / "model_step_4").read_bytes()
            == (tmp_path / "c" / "model_step_4").read_bytes())
    assert ([ln.split("Time Cost")[0] for ln in straight[0]["lines"]]
            == [ln.split("Time Cost")[0] for ln in rep[0]["lines"]])
    d, r = read_checkpoint(str(tmp_path / "s")), read_checkpoint(str(tmp_path / "r"))
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    flat = torch.cat([r["model"][n].reshape(-1) for n in jax_leaf_order(model)])
    assert torch.equal(d["master"][:flat.numel()], flat)
    argv = ARGV + ["--max-steps", "2", "--partition", "sharded-update", "--train-dir", ""]
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    want = msgs(capsys.readouterr().out.splitlines())
    assert msgs(straight[0]["lines"])[:2] == want and want == ["0.2808"] * 2


def test_sharded_delayed_kill_resume_is_bit_exact(groups, tmp_path):
    """``--overlap delayed``: the straight run against one killed before
    step 5 (both ranks, exit 43, under torchrun) and resumed from step 4."""
    argv = ARGV + ["--max-steps", "6", "--partition", "sharded-update", "--overlap", "delayed"]
    cli_run(groups[2], argv + ["--train-dir", str(tmp_path / "s")])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "atomo_tpu_torch"] + argv
        + ["--train-dir", str(tmp_path / "k"), "--chaos", "kill@5", "--device", "cpu"],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0 and "exitcode  : 43" in proc.stderr, proc.stderr[-3000:]
    assert sorted(p.name for p in (tmp_path / "k").glob("model_step_*")) == [
        "model_step_2", "model_step_4"]
    resumed = cli_run(groups[2], argv + ["--train-dir", str(tmp_path / "k"), "--resume"])
    assert not [w for w in resumed[0]["warnings"] if "resume" in w], resumed[0]["warnings"]
    assert ((tmp_path / "s" / "model_step_6").read_bytes()
            == (tmp_path / "k" / "model_step_6").read_bytes())
    assert "overlap_carry" in read_checkpoint(str(tmp_path / "k"))


@pytest.mark.parametrize("partition,warning", [
    ("sharded-update", "--partition sharded-update resume: checkpoint layout does not match "
                       "(it holds per-leaf params, not a master vector); restoring params "
                       "only, optimizer state re-initialized sharded"),
    ("zero1", "--zero1 resume: checkpoint optimizer layout does not match this mesh's zero1 "
              "layout; params restored, optimizer state re-initialized sharded"),
], ids=["sharded", "zero1"])
def test_replicated_checkpoint_resumes_into_a_partition(groups, tmp_path, partition, warning):
    cli_run(groups[2], ARGV + ["--max-steps", "2", "--train-dir", str(tmp_path)])
    before = read_checkpoint(str(tmp_path))
    out = cli_run(groups[2], ARGV + ["--max-steps", "4", "--train-dir", str(tmp_path),
                                     "--resume", "--partition", partition])
    assert warning in out[0]["warnings"], out[0]["warnings"]
    assert f"Resumed from {tmp_path} at step 2" in out[0]["lines"]
    after = read_checkpoint(str(tmp_path), 4)
    assert after["opt_state"]["count"] == 2  # the momentum started afresh at step 2
    assert (after["model"] if partition == "zero1" else after["buffers"]) is not None
    assert before["opt_state"]["count"] == 2


def test_zero1_delayed_resume_is_refused(groups, tmp_path):
    argv = ARGV + ["--max-steps", "2", "--train-dir", str(tmp_path), "--zero1", "--overlap",
                   "delayed", "--resume", "--device", "cpu"]
    with pytest.raises(AssertionError, match="--overlap delayed cannot resume a --zero1 run"):
        groups[2].run("cli", argv=argv)


@pytest.mark.parametrize("flags,want", [
    (["--partition", "sharded-update"],
     ["--partition sharded_update is wired into the distributed loop; the single-device path "
      "trains the replicated update (the --zero1 precedent — there is nothing to shard a "
      "1-chip update over)"]),
    (["--zero1"],
     ["--zero1 needs a multi-device mesh; single-device training has no dp axis to shard "
      "the optimizer state over — ignoring it",
      "--partition zero1 is wired into the distributed loop; the single-device path trains "
      "the replicated update (the --zero1 precedent — there is nothing to shard a 1-chip "
      "update over)"]),
], ids=["sharded", "zero1"])
def test_single_process_warns_and_trains_replicated(flags, want):
    argv = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--batch-size",
            "8", "--max-steps", "2", "--log-interval", "1", "--eval-freq", "0", "--code",
            "qsgd", "--train-dir", "", "--device", "cpu"]
    torch.manual_seed(0)
    plain, part = [], []
    assert cli.main(argv, log_fn=plain.append) == 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert cli.main(argv + flags, log_fn=part.append) == 0
    assert [str(w.message) for w in caught if "mesh" in str(w.message)
            or "distributed loop" in str(w.message)] == want
    assert [ln.split("Time Cost")[0] for ln in part] == [ln.split("Time Cost")[0] for ln in plain]


def test_reshard_sharded_update_three_ranks_to_two(groups):
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    init_params(model, 0)
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    batches = J.batches("mnist", 12, 4)
    host = groups[3].run("partition_host", state_dict=sd, image_shape=(28, 28, 1),
                         batches=batches[:2])[0]
    assert host["step"] == 2 and host["opt"]["count"] == 2
    out = groups[2].run("partition_reshard", state_dict=sd, image_shape=(28, 28, 1), host=host,
                        batches=batches[2:])
    for a in out:
        assert a["slices"] and a["same"] == [True, True] and a["n"] == 2, a


CFG = dict(vocab_size=16, max_len=16, width=32, depth=2, num_heads=2)


def test_reshard_model_axes_lm_to_tp_and_back(groups):
    out = groups[2].run("reshard_lm", cfg=CFG, codec=("svd", {"svd_rank": 2}))
    for a in out:
        assert a["tp_equal"] and a["round_trip"] and a["splits"] and a["loss_finite"], a
        assert a["carry_reset"], a
        assert a["no_codec"] is not None and "needs the run's codec" in a["no_codec"]
        assert a["ep"] is not None and "layout-owned param tree" in a["ep"]
