"""The slice as a whole with ``qsgd``: train steps of the port against the
JAX trainer, LeNet and ResNet-18 (the cases and tolerances of
``test_torch_trainer.py``, whose test this runs; a file of its own, so that
the two codecs balance over test workers)."""

import pytest
from test_torch_trainer import CASES

import test_torch_trainer as sgd_file


@pytest.mark.parametrize("code", ["qsgd"])
@pytest.mark.parametrize("name,dataset,x64", CASES)
def test_train_steps_match_jax(name, dataset, x64, code, monkeypatch):
    sgd_file.test_train_steps_match_jax(name, dataset, x64, code, monkeypatch)
