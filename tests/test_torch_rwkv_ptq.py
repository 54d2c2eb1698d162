"""Port parity for SmoothQuant+ on rwkv6-7b's f32 smoke config (its
``u_bonus``, drawn zero by the reference, filled from a seed): the checks of
``test_torch_ssm_ptq.py`` (statistics, smoothing with the ``linear_out_sqrt``
channel-mix fusion and the ``w_lora_a`` row compensation, SmoothQuant+ end
to end, the artifact both ways, AWQ), against the JAX package on the CPU.
"""
import pytest

from test_torch_ssm_ptq import (check_artifact, check_awq,
                                check_smoothquant_plus,
                                check_stats_and_smoothing, reference_ptq)


@pytest.fixture(scope="module")
def ref():
    return reference_ptq("rwkv6-7b")


def test_stats_and_smoothing_match_jax(ref):
    check_stats_and_smoothing(ref)


def test_smoothquant_plus_matches_jax(ref):
    check_smoothquant_plus(ref)


def test_artifact_loads_in_either_package(ref, tmp_path):
    check_artifact(ref, tmp_path)


def test_awq_matches_jax(ref):
    check_awq(ref)
