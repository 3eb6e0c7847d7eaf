"""``stencil_apply_mc`` (the cross-channel linear stencil) through the
PyTorch port against the JAX package's Pallas kernel, on the CPU.

The reference's kernel takes a closure ``fn(tap) -> (C_out, rows, W)``;
the port takes a ``LinearStencilOp`` tap table.  Each case gives the
Pallas kernel (in interpret mode, as the JAX package's own tests run it) a
closure computing the table's linear map, and holds the port's plain
version to it.  The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here, too: the form
chooser, each form's launch for a tensor on a GPU (a fake library), and
the run forms' tables and summation order replayed in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu.kernels import pallas_ops
from reforge_tpu_torch.kernels import cuda_ops

# XLA contracts the closure's multiply-adds into FMAs where the port
# rounds each product; over at most 4 * 5 * 7 = 140 terms of values in
# [0, 1] and weights of about 1 the two differ by a few ulps of the sum.
TOL = 2e-5


def _table(c_out, c_in, rh, rw, seed, density=1.0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c_out, c_in, 2 * rh + 1, 2 * rw + 1)).astype(np.float32)
    w[rng.random(w.shape) >= density] = 0.0
    w[:, :, rh, 0] = 0.0  # zero terms are skipped, as the kernel skips them
    return w


def _closure(w):
    """The reference's form of the same linear map: fn(tap) over the
    strip's (C_in, rows, W) windows."""
    c_out, c_in, kh, kw = w.shape

    def fn(tap):
        outs = []
        for o in range(c_out):
            acc = None
            for c in range(c_in):
                for dy in range(kh):
                    for dx in range(kw):
                        if w[o, c, dy, dx] == 0.0:
                            continue
                        t = tap(dy, dx)[c] * float(w[o, c, dy, dx])
                        acc = t if acc is None else acc + t
            outs.append(acc)
        return jnp.stack(outs)

    return fn


CASES = [  # (C_out, rh, rw, H, W)
    (3, 1, 1, 21, 37),
    (4, 1, 1, 19, 41),
    (3, 2, 3, 23, 35),
    (4, 2, 3, 17, 43),
]


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("c_out,rh,rw,h,w", CASES)
def test_plain_matches_pallas_stencil_apply_mc(c_out, rh, rw, h, w, mode):
    x = np.random.default_rng(h * w).random((4, h, w), dtype=np.float32)
    # A third of the (2, 3) table's terms: the interpreted closure costs a
    # few seconds per hundred terms.
    table = _table(c_out, 4, rh, rw, seed=c_out + rh, density=1.0 if rh == 1 else 0.3)
    want = np.asarray(pallas_ops.stencil_apply_mc(
        jnp.asarray(x), rh, rw, _closure(table), c_out, mode=mode, interpret=True))
    op = cuda_ops.LinearStencilOp(table)
    got = cuda_ops.stencil_apply_mc(torch.from_numpy(x), op, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (c_out, h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_plain_version_sums_terms_in_table_order():
    """Each output channel's terms run in ascending (c, dy, dx), products
    added one after another: bit-equal to the same loop in float32."""
    x = np.random.default_rng(1).random((4, 9, 13), dtype=np.float32)
    table = _table(2, 4, 1, 2, seed=7)
    op = cuda_ops.LinearStencilOp(table)
    got = cuda_ops.stencil_apply_mc_plain(torch.from_numpy(x), op, "edge").numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (2, 2)), mode="edge")
    for o in range(2):
        acc = None
        for c in range(4):
            for dy in range(3):
                for dx in range(5):
                    wv = np.float32(table[o, c, dy, dx])
                    if wv == 0.0:
                        continue
                    t = xp[c, dy:dy + 9, dx:dx + 13] * wv
                    acc = t if acc is None else acc + t
        np.testing.assert_array_equal(got[o], acc)
    assert op.n_terms == int(np.count_nonzero(table))
    assert [t[:3] for t in op.terms[0][:2]] == [(0, 0, 0), (0, 0, 1)]


def test_bf16_input_and_empty_channel():
    table = _table(3, 4, 1, 1, seed=2)
    table[1] = 0.0  # an output channel with no terms is zero
    op = cuda_ops.LinearStencilOp(table)
    x = torch.from_numpy(np.random.default_rng(2).random((4, 11, 17), dtype=np.float32))
    got = cuda_ops.stencil_apply_mc(x.to(torch.bfloat16), op, "zero")
    assert got.dtype == torch.bfloat16
    assert float(got[1].float().abs().max()) == 0.0
    want = cuda_ops.stencil_apply_mc_plain(x.to(torch.bfloat16).float(), op, "zero")
    assert float((got.float() - want).abs().max()) <= 2.0 ** -7 * float(want.abs().max())


def test_checks_and_counts_nothing_on_the_cpu():
    cuda_ops.reset_launches()
    op = cuda_ops.LinearStencilOp(_table(4, 4, 2, 2, seed=3))
    x = torch.rand(4, 10, 12)
    cuda_ops.stencil_apply_mc(x, op)
    assert set(cuda_ops.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        cuda_ops.stencil_apply_mc(x[:3], op)  # the table takes four channels
    with pytest.raises(ValueError):
        cuda_ops.stencil_apply_mc(x, op, mode="wrap")
    with pytest.raises(TypeError):
        cuda_ops.stencil_apply_mc(x.double(), op)
    with pytest.raises(ValueError):
        cuda_ops.LinearStencilOp(np.zeros((4, 4, 2, 3), np.float32))  # even window
    # radius 2 on four channels fits the soft budget; radius 40 fits no tile
    assert cuda_ops.choose_stencil_mc_tile(4, 2, 2, op.n_terms, 4)[2] <= cuda_ops.SMEM_SOFT
    assert cuda_ops.choose_stencil_mc_tile(4, 40, 40, 4 * 4 * 81 * 81, 4) is None


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _FakeLibrary:
    def __init__(self, rc):
        self.rc = rc
        self.calls = []

    def rf_stencil_apply_mc(self, *args):
        self.calls.append(args)
        return self.rc

    def rf_error_string(self, rc):
        return b"refused"


@pytest.mark.parametrize("r", [2, 40])  # a shared-memory tile; the global-memory path
@pytest.mark.parametrize("rc", [0, 1])
def test_never_takes_the_plain_version_on_a_gpu(rc, r, monkeypatch):
    """For a tensor on a GPU the wrapper launches the kernel (counted) or
    raises; it never runs its plain version."""

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a GPU tensor")

    lib = _FakeLibrary(rc)
    monkeypatch.setattr(cuda_ops, "stencil_apply_mc_plain", no_plain)
    monkeypatch.setattr(cuda_ops, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_ops, "_stream", lambda x: 0)
    op = cuda_ops.LinearStencilOp(_table(3, 4, r, r, seed=r))
    x = torch.rand(4, 8, 16).as_subclass(_ReportsCuda)
    assert x.is_cuda
    cuda_ops.reset_launches()
    if rc:
        with pytest.raises(RuntimeError, match="stencil_apply_mc launch failed"):
            cuda_ops.stencil_apply_mc(x, op)
        assert cuda_ops.LAUNCHES["stencil_apply_mc"] == 0
    else:
        out = cuda_ops.stencil_apply_mc(x, op)
        assert tuple(out.shape) == (3, 8, 16)
        assert cuda_ops.LAUNCHES["stencil_apply_mc"] == 1
        in_shared, smem = lib.calls[0][12], lib.calls[0][-2]
        assert (in_shared, smem == 0) == ((1, False) if r == 2 else (0, True))
    assert len(lib.calls) == 1


# (C_out, C_in, rh, rw, density, the form chosen)
FORM_CASES = [
    (4, 4, 2, 2, 1.0, "run"),
    (4, 4, 2, 2, 0.5, "run_masked"),
    (1, 1, 1, 1, 1.0, "run"),
    (3, 4, 2, 3, 1.0, "run"),
    (4, 4, 3, 3, 1.0, "run"),
    (2, 3, 1, 3, 0.5, "run_masked"),
    (4, 2, 3, 1, 0.3, "run_masked"),
    (4, 4, 4, 4, 1.0, "shared"),  # a radius past the run forms
    (4, 4, 1, 4, 1.0, "shared"),
    (4, 4, 0, 2, 1.0, "shared"),  # radius 0
    (5, 4, 2, 2, 1.0, "shared"),  # five output channels
    (4, 5, 1, 1, 0.5, "shared"),  # five input channels
    (3, 4, 24, 24, 1.0, "global"),  # no shared-memory tile holds the window
]


def _op(c_out, c_in, rh, rw, density, seed=5):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c_out, c_in, 2 * rh + 1, 2 * rw + 1)).astype(np.float32)
    w[rng.random(w.shape) >= density] = 0.0
    return cuda_ops.LinearStencilOp(w)


@pytest.mark.parametrize("case", FORM_CASES, ids=lambda c: f"{c[0]}<-{c[1]} r{c[2]},{c[3]} "
                                                          f"d{c[4]} {c[5]}")
def test_form_chooser(case):
    c_out, c_in, rh, rw, density, form = case
    op = _op(c_out, c_in, rh, rw, density)
    got, th, tw, smem = cuda_ops.choose_stencil_mc_form(op)
    assert got == form
    if form.startswith("run"):
        assert (th, tw) == cuda_ops.STENCIL_MC_RUN_TILE
        assert smem == cuda_ops.stencil_mc_run_footprint(c_in, c_out, rh, rw) <= cuda_ops.SMEM_LIMIT
        assert op.full == (form == "run")
    elif form == "shared":
        assert (th, tw, smem) == cuda_ops.choose_stencil_mc_tile(c_in, rh, rw, op.n_terms, c_out)
    else:
        assert smem == 0 and (th, tw) == cuda_ops.STENCIL_MC_GLOBAL_TILE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FORM_CASES, ids=lambda c: c[5] + f" r{c[2]},{c[3]} {c[0]}<-{c[1]}")
def test_each_form_launches_on_a_gpu(case, dtype, monkeypatch):
    """For a tensor on a GPU every form launches once (counted) with its
    form's arguments, in f32 and bf16, and never runs the plain version."""
    c_out, c_in, rh, rw, density, form = case

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a GPU tensor")

    lib = _FakeLibrary(0)
    monkeypatch.setattr(cuda_ops, "stencil_apply_mc_plain", no_plain)
    monkeypatch.setattr(cuda_ops, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_ops, "_stream", lambda x: 0)
    op = _op(c_out, c_in, rh, rw, density)
    x = torch.rand(c_in, 8, 16).to(dtype).as_subclass(_ReportsCuda)
    cuda_ops.reset_launches()
    out = cuda_ops.stencil_apply_mc(x, op, "zero")
    assert out.dtype == dtype and tuple(out.shape) == (c_out, 8, 16)
    assert cuda_ops.LAUNCHES["stencil_apply_mc"] == 1 and len(lib.calls) == 1
    args = lib.calls[0]
    assert (args[0], args[9], args[17]) == (int(dtype == torch.bfloat16), 1,
                                            {"run": 1, "run_masked": 2}.get(form, 0))
    assert args[12] == int(form != "global")
    assert args[-2] == cuda_ops.choose_stencil_mc_form(op)[3]
    run = form.startswith("run")
    assert (args[13] is None, args[18] is None) == (run, not run)
    assert args[20] == op.nonempty


def _run_form_replay(x, op, mode):
    """The run forms' loop in numpy float32, from their tables
    (``device_run_terms``): for each input channel c and window row dy,
    each dx and output channel o, add the product where the term's mask
    bit is set; each output starts at -0, or +0 where its channel has no
    term."""
    weights, masks = (t.numpy() for t in op.device_run_terms(torch.device("cpu")))
    kh, kw = 2 * op.rh + 1, 2 * op.rw + 1
    rows = weights.reshape(op.c_in * kh, -1)
    h, w = x.shape[1:]
    xp = np.pad(x, ((0, 0), (op.rh, op.rh), (op.rw, op.rw)),
                mode="edge" if mode == "edge" else "constant")
    acc = [np.full((h, w), -0.0 if op.nonempty >> o & 1 else 0.0, np.float32)
           for o in range(op.c_out)]
    for c in range(op.c_in):
        for dy in range(kh):
            row = c * kh + dy
            for dx in range(kw):
                for o in range(op.c_out):
                    if masks[row] >> (o * kw + dx) & 1:
                        acc[o] = acc[o] + xp[c, dy:dy + h, dx:dx + w] * rows[row, o * kw + dx]
    return np.stack(acc)


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("density", [1.0, 0.4])
def test_run_form_order_matches_the_plain_version(density, mode):
    """The run forms' tables and loop order, replayed on the CPU, give the
    plain version's bits, -0 and +0 included."""
    op = _op(3, 4, 2, 3, density, seed=11)
    if density < 1.0:
        op = cuda_ops.LinearStencilOp(np.concatenate([op.weights[:2], 0 * op.weights[2:]]))
        assert op.nonempty == 0b011
    x = np.random.default_rng(12).random((4, 19, 27), dtype=np.float32) - 0.5
    want = cuda_ops.stencil_apply_mc_plain(torch.from_numpy(x), op, mode).numpy()
    got = _run_form_replay(x, op, mode)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
