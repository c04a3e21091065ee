"""The LM step on dp x sp meshes of 4 gloo ranks against the JAX package's
dp-sp step: the cases of ``test_torch_lm_dist_steps.py`` at 2x2 and 1x4, and
the dp tail's gradient at sp = 4 against the unsharded one, with that file's
tolerances (its docstring). A file of its own, so that the 2-rank and the
4-rank cases balance over test workers."""

import pytest
from test_torch_lm_dist_steps import cases, groups, start  # noqa: F401 (fixtures)

import test_torch_lm_dist_steps as two


@pytest.mark.parametrize("dp,sp,impl,code,aggregate", cases(4))
def test_lm_steps_match_jax(groups, start, dp, sp, impl, code, aggregate):  # noqa: F811
    two.test_lm_steps_match_jax(groups, start, dp, sp, impl, code, aggregate)


@pytest.mark.parametrize("sp", [4])
def test_sp_gradient_has_no_stray_factor(groups, start, sp):  # noqa: F811
    two.test_sp_gradient_has_no_stray_factor(groups, start, sp)
