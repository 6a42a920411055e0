"""The host side of the FP64 product tile that K22 ``eig_step`` and K26
``dd_matmul`` share (``pymgrit_tpu_torch/ops/product_tile.py``): the plans
of the shapes the port launches and of odd ones, the copy-width predicate,
the workspace the wrappers hand the kernels, and the CPU route of both
wrappers.  Everything here runs on the CPU; the kernels themselves are
held against their plain versions by the ``cuda`` tests of
``tests/test_torch_kernels.py`` and by ``chip_smoke.py`` on the card.
"""

import math

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import dd, dd_matmul, eig_step, product_tile
from pymgrit_tpu_torch.ops.product_tile import (SKINNY, SKINNY_MAX, SMS, TILES, WIDE,
                                                copy_bytes, product_plan)

N = 2400                # Diffusion2D's table at n = 20
ONE_WAVE = 2 * SMS      # the skinny plans put at least two blocks on every SM

# (batch, M, N, K, dtype, a copy, b copy): the launched shapes (K22 at 1, 8,
# 128 and 129 lanes, the DD table at 8 rows, the two-sided 63-wide DD
# products on 1024 lanes), then odd ones
SHAPES = [(1, b, N, N, dt, (16, True), (16, True)) for b in (1, 8, 128, 129)
          for dt in ("float64", "float32")]
SHAPES += [(1, 8, N, N, "dd", (16, True), (16, True)),
           (1024, 63, 63, 63, "dd", (4, True), (4, False))]
SHAPES += [(1, m, n, k, "float64", (8, True), (16, True))
           for m in (1, 7, 9, 65) for n in (50, N) for k in (1, 17, 2401)]
SHAPES += [(3, m, 40, k, "dd", (4, False), (4, True)) for m in (1, 65) for k in (1, 17, 2401)]


def _ids(shape):
    return "x".join(map(str, shape[:5]))


@pytest.mark.parametrize("shape", SHAPES, ids=map(_ids, SHAPES))
def test_plan_slices_partition_the_inner_index(shape):
    batch, M, Nn, K, dtype, a, b = shape
    plan = product_plan(batch, M, Nn, K, dtype, a, b)
    bm, bn, bk = plan.tile
    assert (bm, bn, bk, plan.stages) in [t[:4] for t in TILES]
    # slices of whole k-tiles, in order, covering [0, K) with none empty
    ks = plan.kslices
    assert len(ks) == plan.splits and ks[0][0] == 0 and ks[-1][1] == K
    assert all(k0 < k1 for k0, k1 in ks)
    assert all(ks[i][1] == ks[i + 1][0] for i in range(len(ks) - 1))
    assert all(k0 % bk == 0 for k0, _ in ks) and all(k1 - k0 == plan.kps * bk for k0, k1 in ks[:-1])
    # the long axis on the tile's M side; the short side picks the regime
    assert plan.swap == (M < Nn)
    short = min(M, Nn) if plan.swap else Nn
    assert plan.regime == ("skinny" if short <= SKINNY_MAX else "wide")
    assert bn == (SKINNY if plan.regime == "skinny" else WIDE)[1]
    m, n = (Nn, M) if plan.swap else (M, Nn)
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    assert plan.blocks == tiles * plan.splits * plan.zblocks
    assert 1 <= plan.zblocks <= batch
    assert plan.workspace == (plan.splits * batch * m * n if plan.splits > 1 else 0)
    assert plan.smem <= 232448          # one block's shared memory on an H100
    assert plan.copy == ((b if plan.swap else a)[0], (a if plan.swap else b)[0])
    assert len(plan.launch_args()) == 10


@pytest.mark.parametrize("lanes,dtype", [(1, "float64"), (8, "float64"), (1, "float32"),
                                         (8, "float32"), (1, "dd"), (8, "dd"), (16, "float64"),
                                         (16, "dd")])
def test_skinny_plans_fill_the_card(lanes, dtype):
    plan = product_plan(1, lanes, N, N, dtype)
    assert plan.regime == "skinny" and plan.tile == SKINNY[:3]
    assert plan.blocks >= ONE_WAVE and plan.splits > 1


@pytest.mark.parametrize("lanes", [17, 32, 64, 128])
def test_more_lanes_than_the_crossover_take_the_wide_tile(lanes):
    plan = product_plan(1, lanes, N, N, "float64")
    assert plan.regime == "wide" and plan.tile == WIDE[:3] and plan.swap


def _align(nbytes):
    return 16 if nbytes % 16 == 0 else 8 if nbytes % 8 == 0 else 4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [6, 24, N])
@pytest.mark.parametrize("aligned", [True, False])
def test_eig_step_plan_orders_copies_by_tile_side(dtype, n, aligned):
    """plan.copy is (the tile's A side, its B side): the table's and the
    lanes' widths where the table is the long axis (swap), the lanes' and
    the table's where the lanes are (64 lanes of a table 6 or 24 wide)."""
    lanes = 64
    buf = torch.zeros((lanes, n + 2), dtype=dtype)
    x = buf[:, :n] if aligned else buf[:, 1:n + 1]
    W = V = torch.zeros((n, n), dtype=dtype)
    es = x.element_size()
    # the lanes: x's rows and the contiguous work rows between the products
    lane_copy = max(es, min(_align(x.stride(0) * es), _align(n * es))) if aligned else es
    table_copy = max(es, _align(n * es))
    plan = eig_step.plan(x, W, V)
    assert plan.swap == (lanes < n)
    assert plan.copy == ((table_copy, lane_copy) if plan.swap else (lane_copy, table_copy))


def test_wide_plans_split_below_two_blocks_an_sm_and_not_above():
    plan = product_plan(1, 128, N, N, "float64")           # 76 tiles: split
    assert plan.regime == "wide" and plan.tile[:2] == WIDE[:2] and plan.splits > 1
    plan = product_plan(1024, 63, 63, 63, "dd", (4, True), (4, False))   # 1024 tiles
    assert plan.regime == "wide" and plan.splits == 1 and plan.workspace == 0
    assert plan.copy == (4, 4) and plan.zblocks < 1024      # the blocks walk the batch


def _dd_zeros(shape):
    return dd.from_f64(np.zeros(shape))


def test_alignment_predicate():
    # the two-sided Heat2D DD products: 63-wide rows (252 B) of S and of the
    # 65^2 states' interior are 4-byte aligned only
    S = _dd_zeros((63, 63)).expand(1024, 63, 63)
    ptrs = (S.hi.data_ptr(), S.lo.data_ptr())
    assert copy_bytes(ptrs, S.hi.stride(), (1024, 63, 63), 4) == (4, True)    # not 16
    states = _dd_zeros((4, 65, 65))[:, 1:-1, 1:-1]
    st = states.hi.stride()
    assert copy_bytes((states.hi.data_ptr(), states.lo.data_ptr()), (st[0], st[2], st[1]),
                      (4, 63, 63), 4) == (4, False)      # rows of B^T run along N
    # contiguous 2400-wide float64 rows are
    x = torch.zeros((8, N), dtype=torch.float64)
    assert copy_bytes((x.data_ptr(),), (0, x.stride(0), 1), (1, 8, N), 8) == (16, True)
    # a row stride of 2401 float64 values is 8-byte aligned only
    y = torch.zeros((8, N + 1), dtype=torch.float64)[:, :N]
    assert copy_bytes((y.data_ptr(),), (0, y.stride(0), 1), (1, 8, N), 8) == (8, True)
    # no unit stride: one element a copy
    z = torch.zeros((8, 2 * N), dtype=torch.float32)[:, ::2]
    assert copy_bytes((z.data_ptr(),), (0, z.stride(0), 2), (1, 8, N), 4) == (4, True)


def _no_stream(monkeypatch):
    """The current stream for a CPU-only build: stream 0."""
    from pymgrit_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "stream", lambda index: 0)


class _Recorder:
    """Stands in for a C launcher: records the plan array and the pointer
    it was handed for the workspace."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("lanes", [1, 8, 128])
def test_eig_step_hands_the_kernel_its_plan_and_workspace(monkeypatch, lanes):
    rec, made = _Recorder(), []
    real = product_tile.workspace

    def workspace(plan, dtype, device, lead=0):
        ws = real(plan, dtype, device, lead)
        made.append((plan, ws, lead))
        return ws

    monkeypatch.setattr(product_tile, "workspace", workspace)
    monkeypatch.setattr(eig_step, "_launcher", lambda name, dtype: rec)
    _no_stream(monkeypatch)
    x = torch.zeros((lanes, N), dtype=torch.float64)
    W = V = torch.zeros((N, N), dtype=torch.float64)
    plan = eig_step.plan(x, W, V)
    eig_step._launch(x, torch.empty_like(x), W, V, torch.zeros(N, dtype=torch.float64),
                     torch.zeros(lanes, dtype=torch.float64), plan)
    # one buffer: the (lanes, N) work rows between the products, then the
    # splits x lanes x N partials
    ((args, stream),), ((p, buf, lead),) = rec.calls, made
    assert p == plan and tuple(args[12:]) == plan.launch_args() and list(args[10:12]) == [lanes, N]
    assert lead == lanes * N and buf.dtype == torch.float64
    assert buf.numel() == lead + plan.splits * lanes * N and plan.splits > 1
    assert args[6] == buf.data_ptr() and args[7] == buf.data_ptr() + 8 * lead


def test_dd_matmul_hands_the_kernel_its_plan_and_workspace(monkeypatch):
    from pymgrit_tpu_torch.ops import _build

    class Lib:
        pm_dd_matmul = _Recorder()

    monkeypatch.setattr(_build, "library", lambda: Lib)
    _no_stream(monkeypatch)
    a, b = _dd_zeros((1, 8, N)), _dd_zeros((N, N)).T[None]
    plan = dd_matmul.plan(a, b)
    out = dd_matmul.dd_matmul_plain(a, b)
    dd_matmul._launch(a, b, out, plan)
    ((args, stream),) = Lib.pm_dd_matmul.calls
    assert plan.swap and plan.splits > 1 and tuple(args[20:]) == plan.launch_args()
    assert args[6] != 0 and plan.workspace == plan.splits * 8 * N
    assert list(args[16:20]) == [1, 8, N, N]


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """Neither wrapper reaches the kernel library or plans on CPU tensors."""
    from pymgrit_tpu_torch.ops import _build

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel route")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(product_tile, "product_plan", refuse)
    rng = np.random.default_rng(7)
    n, B = 40, 3
    W, V = (torch.as_tensor(rng.standard_normal((n, n))) for _ in range(2))
    lam, dt = torch.as_tensor(rng.uniform(0, 2, n)), torch.as_tensor(rng.uniform(0.1, 1, B))
    x = torch.as_tensor(rng.standard_normal((B, n)))
    before = eig_step.eig_step.launches
    got = eig_step.eig_step(x, torch.empty_like(x), W, V, lam, dt)
    assert torch.equal(got, eig_step.eig_step_plain(x, torch.empty_like(x), W, V, lam, dt))
    assert eig_step.eig_step.launches == before
    a, b = dd.from_f64(rng.standard_normal((2, 5, 7))), dd.from_f64(rng.standard_normal((2, 7, 4)))
    before = dd_matmul.dd_matmul.launches
    got, want = dd_matmul.dd_matmul(a, b), dd_matmul.dd_matmul_plain(a, b)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    assert dd_matmul.dd_matmul.launches == before
