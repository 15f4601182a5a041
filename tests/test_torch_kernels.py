"""The port's kernel oracles and its two CUDA kernels (B1 gather_quant, B2
stoch_quant) against the reference package.

On the CPU the kernel wrappers take their plain-torch versions; they are
held bitwise against the reference's Pallas kernels run in interpret mode,
through the reference's own padded flat wrappers.  The kernels themselves
are held against the plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gather_quant, ops, ref, stoch_quant
from repro_torch.testing import to_numpy, to_torch

RNG = np.random.default_rng(0)
D_RAGGED = 123_457


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def test_layout_constants():
    assert (ref.LANES, ref.GROUP) == (jref.LANES, jref.GROUP) == (1024, 32)


@pytest.mark.parametrize("rows", [32, 96])
def test_pack_unpack_popcount_refs_bitwise(rows):
    mask = (RNG.random((rows, ref.LANES)) < 0.3).astype(np.uint8)
    words_j = jref.pack_ref(jnp.asarray(mask))
    words_t = ref.pack_ref(torch.from_numpy(mask))
    np.testing.assert_array_equal(to_numpy(words_t, np.uint32),
                                  np.asarray(words_j))
    np.testing.assert_array_equal(ref.unpack_ref(to_torch(words_j)).numpy(),
                                  np.asarray(jref.unpack_ref(words_j)))
    stack = RNG.integers(0, 2**32, (5, rows // 32, ref.LANES), dtype=np.uint32)
    np.testing.assert_array_equal(
        ref.popcount_accum_ref(to_torch(stack)).numpy(),
        np.asarray(jref.popcount_accum_ref(jnp.asarray(stack))))


@pytest.mark.parametrize("tau", [-1.0, 0.0, 0.9])
def test_vote_pack_ref_bitwise(tau):
    scores = RNG.standard_normal((64, ref.LANES)).astype(np.float32)
    got = ref.vote_pack_ref(torch.from_numpy(scores), torch.tensor(tau))
    want = jref.vote_pack_ref(jnp.asarray(scores), jnp.float32(tau))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("f", [1.0, 117.5, 4000.0])
def test_quant_refs_bitwise(f):
    u = (RNG.standard_normal((16, ref.LANES)) * 3).astype(np.float32)
    uni = RNG.random((16, ref.LANES), dtype=np.float32)
    sel = (RNG.random((16, ref.LANES)) < 0.3).astype(np.uint8)
    ft = torch.tensor(f, dtype=torch.float32)
    np.testing.assert_array_equal(
        ref.stoch_quant_ref(torch.from_numpy(u), torch.from_numpy(uni), ft).numpy(),
        np.asarray(jref.stoch_quant_ref(jnp.asarray(u), jnp.asarray(uni),
                                        jnp.float32(f))))
    qt, rt = ref.gather_quant_ref(torch.from_numpy(u), torch.from_numpy(uni),
                                  torch.from_numpy(sel), ft)
    qj, rj = jref.gather_quant_ref(jnp.asarray(u), jnp.asarray(uni),
                                   jnp.asarray(sel), jnp.float32(f))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))


def _quant_inputs(d, density, seed):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(d) * 3).astype(np.float32)
    uni = rng.random(d, dtype=np.float32)
    sel = (rng.random(d) < density).astype(np.uint8)
    return u, uni, sel


@pytest.mark.parametrize("f", [1.0, 117.5, 4000.0])
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
def test_gather_quant_wrapper_matches_pallas_interpret(f, density):
    u, uni, sel = _quant_inputs(D_RAGGED, density, seed=int(f) + int(10 * density))
    before = gather_quant.gather_quant.launches
    qt, rt = ops.gather_quant_flat(torch.from_numpy(u), torch.from_numpy(uni),
                                   torch.from_numpy(sel), f)
    qj, rj = jops.gather_quant_flat(jnp.asarray(u), jnp.asarray(uni),
                                    jnp.asarray(sel), f, interpret=True)
    assert gather_quant.gather_quant.launches == before   # CPU: plain version
    assert qt.dtype == torch.int32 and rt.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))


@pytest.mark.parametrize("f", [1.0, 117.5, 4000.0])
def test_stoch_quant_wrapper_matches_pallas_interpret(f):
    u, uni, _ = _quant_inputs(D_RAGGED, 0.0, seed=int(f))
    before = stoch_quant.stoch_quant.launches
    qt = ops.quantize_flat(torch.from_numpy(u), torch.from_numpy(uni), f)
    qj = jops.quantize_flat(jnp.asarray(u), jnp.asarray(uni), f, interpret=True)
    assert stoch_quant.stoch_quant.launches == before
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_gather_quant_stack_rows_share_sel():
    u = torch.from_numpy(RNG.standard_normal((3, 5000)).astype(np.float32))
    uni = torch.from_numpy(RNG.random((3, 5000), dtype=np.float32))
    sel = torch.from_numpy((RNG.random(5000) < 0.2).astype(np.uint8))
    q, res = ops.gather_quant_flat(u, uni, sel, 50.0)
    for i in range(3):
        qi, ri = ops.gather_quant_flat(u[i], uni[i], sel, 50.0)
        assert torch.equal(q[i], qi) and torch.equal(res[i], ri)
    off = sel == 0
    assert bool((q[:, off] == 0).all()) and torch.equal(res[:, off], u[:, off])


def test_wrappers_reject_bad_operands():
    u = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        gather_quant.gather_quant(u, u, torch.zeros(8, dtype=torch.int32),
                                  torch.tensor(1.0))
    with pytest.raises(ValueError):
        gather_quant.gather_quant(u, u, torch.zeros(7, dtype=torch.uint8),
                                  torch.tensor(1.0))
    with pytest.raises(ValueError):
        stoch_quant.stoch_quant(u, torch.zeros(2, 7), torch.tensor(1.0))


def _strided(base: np.ndarray, start: int, cols: int) -> torch.Tensor:
    """Columns ``[start, start + cols)`` of a row-major array, as a view
    with the array's row stride."""
    return torch.from_numpy(base)[:, start:start + cols]


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("start", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 3])
def test_gather_quant_out_on_strided_views(n, start, in_place):
    """B1's residual written into a caller's view (``out=``), on views 1-3
    columns off a 16-byte boundary with an odd width, N = 1 and 3 rows, out
    of place and into u itself: bitwise the plain call without ``out`` and
    the reference's Pallas kernel (interpret mode), row by row, with the
    columns around the view untouched."""
    rng = np.random.default_rng(100 * n + 10 * start + in_place)
    cols, f = 1001, 117.5
    width = start + cols + 5
    u_base = (rng.standard_normal((n, width)) * 3).astype(np.float32)
    uni_base = rng.random((n, width + 2), dtype=np.float32)
    sel = torch.from_numpy((rng.random(cols) < 0.3).astype(np.uint8))
    u = _strided(u_base.copy(), start, cols)
    uni = _strided(uni_base, 2, cols)
    assert u.stride() == (width, 1)
    q_want, res_want = gather_quant.gather_quant_plain(
        u.clone(), uni, sel, torch.tensor(f))
    at = start if in_place else 3 - start % 3
    out = u if in_place else _strided(
        np.full((n, width + 3), np.nan, dtype=np.float32), at, cols)
    around = out._base.clone()
    q, res = ops.gather_quant_flat(u, uni, sel, f, out=out)
    assert res is out
    np.testing.assert_array_equal(q.numpy(), q_want.numpy())
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(res_want.numpy()))
    outside = torch.ones(around.shape, dtype=torch.bool)
    outside[:, at:at + cols] = False
    assert torch.equal(out._base[outside].view(torch.int32),
                       around[outside].view(torch.int32))
    for i in range(n):
        qj, rj = jops.gather_quant_flat(
            jnp.asarray(u_base[i, start:start + cols]),
            jnp.asarray(uni_base[i, 2:2 + cols]), jnp.asarray(sel.numpy()), f,
            interpret=True)
        np.testing.assert_array_equal(q[i].numpy(), np.asarray(qj))
        np.testing.assert_array_equal(_bits(out[i].numpy()), _bits(rj))


def test_gather_quant_rejects_bad_views():
    """Column strides other than 1, and an ``out`` that shares memory with
    the operands other than as u itself, raise on every device."""
    base = torch.zeros(3, 40)
    u, uni = base[:, 1:17], torch.zeros(3, 16)
    sel, f = torch.zeros(16, dtype=torch.uint8), torch.tensor(2.0)
    gather_quant.gather_quant(u, uni, sel, f, out=u)              # in place
    gather_quant.gather_quant(u, uni, sel, f,
                              out=torch.zeros(3, 40)[:, 20:36])  # elsewhere
    bad_columns = [(base[:, ::2][:, :16], uni, sel, None),
                   (u, torch.zeros(3, 32)[:, ::2], sel, None),
                   (u, uni, torch.zeros(32, dtype=torch.uint8)[::2], None),
                   (u, uni, sel, torch.zeros(3, 32)[:, ::2])]
    for a, b, s, o in bad_columns:
        with pytest.raises(ValueError, match="column stride"):
            gather_quant.gather_quant(a, b, s, f, out=o)
    overlapping = [base[:, 2:18],                    # u shifted one column
                   base[:, :16],                     # u one column back
                   base[:, 20:36],                   # between u's rows
                   uni,                              # the uniforms
                   torch.zeros(1, 16).expand(3, 16),  # rows on one another
                   torch.zeros(3, 16, dtype=torch.float64)]
    for o in overlapping:
        with pytest.raises(ValueError, match="out"):
            gather_quant.gather_quant(u, uni, sel, f, out=o)
