"""K7 ``theta_rhs2d``'s halo mode: the stencil pass of a physical Heat2D
step on a space slab (rows [s R, (s + 1) R) of the (P, Q) state), with the
neighbouring slabs' edge rows as operands and None where the slab's edge is
the grid's ring.

Held on the CPU (the plain version and the wrapper's checks and packed
arguments, with a stand-in launcher):

* on every slab of a state (n_space 2 and 4), FE (+ g), BE and CN (a dt
  tensor, time-dependent rhs rows), float64 and float32: the halo mode's
  plain version equals the whole-state mode's rows bit for bit (the same
  operations on the same values): FE every row of the slab, BE/CN the
  slab's rows off the ring;
* the wrapper takes the plain version for CPU tensors and launches
  nothing; its checks raise on a malformed halo; the launch it would make
  carries the slab's rows, the halo rows' pointers (0 at the grid's ring)
  and their batch stride.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  On the card

    python -m pytest tests/test_torch_k7_halo.py -q -m cuda --noconftest

holds the halo mode against its plain version on the card and against the
kernel's whole-state mode restricted to the slab, bit for bit, in float64
and float32.
"""

import ctypes

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, _build, theta_rhs

torch.set_num_threads(1)

THETA = {"BE": 1.0, "CN": 0.5, "FE": 0.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed):
    return torch.as_tensor(np.random.default_rng(seed).uniform(-1, 1, shape), dtype=dtype,
                           device=device)


class Case:
    """One K7 call's operands on a whole (B, P, Q) state: u, the rhs rows
    (one row at stride 0, or one a state), the lift, the ring field, g (FE)
    and dt (a float or a (B,) tensor); ``whole(ops)`` and ``slab(ops, s,
    n)`` make the call on the whole state or on slab s of n."""

    def __init__(self, method, B, P, Q, dtype=torch.float64, device="cpu", dt_tensor=False,
                 rows=False, with_g=False, seed=0):
        self.theta = THETA[method]
        self.B, self.P, self.Q = B, P, Q
        N = (P - 2) * (Q - 2)
        self.fx, self.fy = (P - 1.0) ** 2, (Q - 1.0) ** 2
        self.u = _rand((B, P, Q), dtype, device, seed)
        r = _rand((2 * B if rows else 2, N), dtype, device, seed + 1)
        self.r1, self.r0 = ((r[:B], r[B:]) if rows
                            else (r[0].expand(B, N), r[1].expand(B, N)))
        self.lift = _rand((P - 2, Q - 2), dtype, device, seed + 2)
        self.ring = _rand((P, Q), dtype, device, seed + 3)
        self.ring[1:-1, 1:-1] = 0.0
        self.g = _rand((B, P, Q), dtype, device, seed + 4) * 1e-2 if with_g else None
        self.dt = (torch.as_tensor(np.random.default_rng(seed + 5).uniform(0.5, 1.0, B) / 4096,
                                   dtype=dtype, device=device) if dt_tensor else 1.0 / 4096)

    def _call(self, ops, u, r1, r0, lift, ring, g, halo):
        fe = self.theta == 0.0
        B, R, Q = u.shape
        n_in = R - (halo is None or halo[0] is None) - (halo is None or halo[1] is None)
        out = torch.full((B, R, Q) if fe else (B, n_in, Q - 2), float("nan"), dtype=u.dtype,
                         device=u.device)
        return ops.theta_rhs2d(u, out, self.dt, self.theta, self.fx, self.fy, r1, r0,
                               lift=None if fe else lift, ring=ring if fe else None, g=g,
                               halo=halo)

    def whole(self, ops):
        return self._call(ops, self.u, self.r1, self.r0, self.lift, self.ring, self.g, None)

    def bounds(self, s, n):
        """(the slab's rows, its rows off the ring as interior rows)."""
        R = self.P // n
        r0, r1 = s * R, (s + 1) * R
        return slice(r0, r1), slice(max(r0, 1) - 1, min(r1, self.P - 1) - 1)

    def slab(self, ops, s, n):
        rows, inner = self.bounds(s, n)
        u = self.u[:, rows]
        above = None if s == 0 else self.u[:, rows.start - 1].contiguous()
        below = None if s == n - 1 else self.u[:, rows.stop].contiguous()
        N = (inner.stop - inner.start) * (self.Q - 2)
        k = inner.start * (self.Q - 2)
        return self._call(ops, u, self.r1[:, k:k + N], self.r0[:, k:k + N],
                          self.lift[inner].contiguous(), self.ring[rows].contiguous(),
                          None if self.g is None else self.g[:, rows], (above, below))

    def whole_rows(self, out, s, n):
        """The rows of a whole-state call's out that slab s's call writes."""
        rows, inner = self.bounds(s, n)
        return out[:, rows] if self.theta == 0.0 else out[:, inner]


# (method, B, P, Q, options): FE with g, BE, CN; a dt tensor, one rhs row a
# state; P splits in 2 and 4
OPTIONS = [dict(), dict(dt_tensor=True), dict(rows=True), dict(dt_tensor=True, rows=True)]
CPU_CASES = [(m, o) for m in ("FE", "BE", "CN") for o in OPTIONS]


def _same_bits(a, b):
    assert a.shape == b.shape
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    w = ~torch.isnan(a)
    assert torch.equal(a[w], b[w])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("method,opt", CPU_CASES)
def test_halo_plain_equals_whole_rows(dtype, n_space, method, opt):
    case = Case(method, 3, 16, 11, dtype, with_g=method == "FE", **opt)
    whole = case.whole(PLAIN)
    for s in range(n_space):
        _same_bits(case.slab(PLAIN, s, n_space), case.whole_rows(whole, s, n_space))


@pytest.mark.parametrize("method", ["FE", "CN"])
def test_halo_rows_are_read(method):
    """A change of a halo row moves the slab's edge row, and only it (the
    stencil's north / south neighbour comes from the operand)."""
    case = Case(method, 2, 16, 9)
    base = case.slab(PLAIN, 1, 2)
    case.u[:, 7] += 1.0                    # the row above slab 1 of 2
    moved = case.slab(PLAIN, 1, 2)
    changed = (moved != base).any(dim=(0, 2))
    assert changed[0] and not changed[1:].any()


def test_cpu_takes_the_plain_version():
    case = Case("CN", 3, 16, 11, with_g=False)
    before = theta_rhs.theta_rhs2d.launches, dict(theta_rhs.theta_rhs2d.mode_launches)
    got = case.slab(DISPATCH, 1, 4)
    assert (theta_rhs.theta_rhs2d.launches, theta_rhs.theta_rhs2d.mode_launches) == before
    _same_bits(got, case.slab(PLAIN, 1, 4))


def _args(R=4, Q=7, B=3, above=True, below=True, **over):
    f = dict(dtype=torch.float64)
    n_in = R - (not above) - (not below)
    N = n_in * (Q - 2)
    args = dict(u=torch.zeros((B, R, Q), **f), out=torch.empty((B, n_in, Q - 2), **f), dt=1e-3,
                theta=0.5, fx=1.0, fy=1.0, rhs1=torch.zeros(N, **f).expand(B, N),
                rhs0=torch.zeros(N, **f).expand(B, N), lift=torch.zeros((n_in, Q - 2), **f),
                halo=(torch.zeros((B, Q), **f) if above else None,
                      torch.zeros((B, Q), **f) if below else None))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(halo=(torch.zeros((3, 6), dtype=torch.float64), None)), "halo rows"),
    (dict(halo=(torch.zeros((3, 7), dtype=torch.float64),
                torch.zeros((3, 14), dtype=torch.float64)[:, :7])), "equal strides"),
    (dict(halo=(torch.zeros((3, 7), dtype=torch.float32), None)), "dtype"),
    (dict(out=torch.empty((3, 2, 5), dtype=torch.float64)), "out has shape"),
    (dict(lift=torch.zeros((2, 5), dtype=torch.float64)), "lift"),
])
def test_halo_checks_raise(over, match):
    with pytest.raises(ValueError, match=match):
        theta_rhs.theta_rhs2d(**_args(**over))
    theta_rhs.theta_rhs2d(**_args())


def test_a_slab_needs_a_row_off_the_ring():
    """One row whose only edge is the grid's ring leaves no row to write."""
    a = _args(R=1, above=False)
    with pytest.raises(ValueError, match="interior"):
        theta_rhs.theta_rhs2d(**a)


@pytest.mark.parametrize("method", ["BE", "CN", "FE"])
@pytest.mark.parametrize("s", [0, 1, 3])
def test_halo_launch_the_wrapper_would_make(monkeypatch, method, s):
    """A CUDA-free look at a halo call's launch: the cached checks see the
    operands as CUDA tensors, a stand-in launcher reads the packed array:
    the mode, u's rows (the slab's), the halo pointers (0 at the grid's
    ring) and their batch stride."""
    case = Case(method, 3, 16, 11, with_g=method == "FE")
    seen = {}

    def launcher(addr, dt, theta, fx, fy, stream):
        seen["args"] = list((ctypes.c_int64 * 23).from_address(addr))
        return 0

    real = theta_rhs._checked

    def checked(facts, present, theta):
        cuda = tuple((dt, torch.device("cuda", 0), sh, st) for dt, _, sh, st in facts)
        on_cpu, (args, _, index) = real.__wrapped__(cuda, present, theta)
        return on_cpu, (args, launcher, index)

    monkeypatch.setattr(theta_rhs, "_checked", checked)
    monkeypatch.setattr(theta_rhs, "_launcher", lambda name, dt: None)
    monkeypatch.setattr(_build, "stream", lambda index: None)
    rows, _ = case.bounds(s, 4)
    above = None if s == 0 else case.u[:, rows.start - 1]
    below = None if s == 3 else case.u[:, rows.stop]
    fe = method == "FE"
    n_in = 4 - (above is None) - (below is None)
    out = torch.empty((3, 4, 11) if fe else (3, n_in, 9), dtype=torch.float64)
    theta_rhs.theta_rhs2d(case.u[:, rows], out, 1e-3, case.theta, 1.0, 1.0,
                          case.r1[:, :n_in * 9], case.r0[:, :n_in * 9],
                          lift=None if fe else case.lift[:n_in].clone(),
                          ring=case.ring[rows].clone() if fe else None, halo=(above, below))
    args = seen["args"]
    assert args[16:20] == [3, 4, 11, theta_rhs.MODES[method]]
    assert args[20:22] == [0 if h is None else h.data_ptr() for h in (above, below)]
    assert args[22] == 16 * 11                 # the halo rows' batch stride: u's


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("method,opt", [("FE", {}), ("FE", dict(dt_tensor=True, rows=True)),
                                        ("BE", {}), ("CN", dict(dt_tensor=True)),
                                        ("CN", dict(rows=True))])
@pytest.mark.parametrize("B,P,Q", [(16, 128, 130), (5, 16, 11)])
def test_halo_mode_bit_for_bit_on_card(cuda, dtype, n_space, method, opt, B, P, Q):
    """On every slab: the kernel's halo mode against its plain version on
    the card and against the kernel's whole-state mode's rows."""
    case = Case(method, B, P, Q, dtype, cuda, with_g=method == "FE", **opt)
    whole = case.whole(DISPATCH)
    for s in range(n_space):
        before = DISPATCH.theta_rhs2d.mode_launches["halo"]
        got = case.slab(DISPATCH, s, n_space)
        torch.cuda.synchronize()
        assert DISPATCH.theta_rhs2d.mode_launches["halo"] == before + 1
        _same_bits(got, case.slab(PLAIN, s, n_space))
        _same_bits(got, case.whole_rows(whole, s, n_space))
