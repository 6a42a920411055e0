"""The sharded executor on the card (tests marked ``cuda``; they skip
without a GPU): the communication layer's staging route (gloo with CUDA
tensors, through pinned host buffers) in a two-process world on cuda:0, an
NCCL world of one, and a small sharded Heat2D solve on the card against
the port's serial solve on the CPU.  No JAX here: on the card's machine

    python -m pytest tests/test_torch_shard_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import pymgrit_tpu_torch as P
import torch_shard_workers as W

pytestmark = pytest.mark.cuda

HEAT = dict(name="heat2d_card", P=2, device="cuda", build="heat2d",
            build_kw=dict(nts=(65, 17, 5), basis="spectral"), entry="solve_compiled",
            solver_kw=dict(tol=1e-10))
GLOO = [dict(name="staged", P=2, probe="comm_ops", device="cuda"), HEAT]
NCCL = [dict(name="nccl", P=1, probe="comm_ops", device="cuda")]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _world(size, cases, directory, backend):
    w = W.start_world(size, cases, directory, backend)
    try:
        return {c["name"]: w.result(c["name"]) for c in cases}
    finally:
        w.close()


def test_gloo_on_the_card_stages_through_the_host(card, tmp_path):
    out = _world(2, GLOO, tmp_path, "gloo")
    for r, res in enumerate(out["staged"]):
        assert res["backend"] == "gloo" and res["staged"]
        assert np.array_equal(res["shift"], np.full((3, 2), max(r - 1, 0.0)))
        assert np.array_equal(res["broadcast"], np.full(2, 1.0))
        assert res["sum"] == 3.0 and res["max"] == 1.0
        assert np.array_equal(res["gather"], np.array([[0.0, 0.0], [1.0, 1.0]]))
        assert res["counts"]["staged"] > 0
    ranks = out["heat2d_card"]
    assert np.array_equal(ranks[0]["conv"], ranks[1]["conv"])
    problem, _ = W.heat2d(P, W.PORT, **HEAT["build_kw"])
    m = P.Mgrit(problem=problem, tol=1e-10, logging_lvl=30)
    m.solve_compiled()
    it = m.solve_iter
    assert ranks[0]["solve_iter"] == it
    np.testing.assert_allclose(ranks[0]["conv"][1:it + 1], m.conv[1:it + 1], rtol=1e-9,
                               atol=1e-15)
    np.testing.assert_allclose(ranks[0]["tube"][0], m.u[0].numpy(), rtol=1e-12, atol=1e-14)


def test_nccl_world_of_one(card, tmp_path):
    res = _world(1, NCCL, tmp_path, "nccl")["nccl"][0]
    assert res["backend"] == "nccl" and not res["staged"]
    assert np.array_equal(res["shift"], np.zeros((3, 2)))
    assert res["sum"] == 1.0 and res["max"] == 0.0
    assert res["counts"] == {"ops": 5, "bytes": 0, "staged": 0}
