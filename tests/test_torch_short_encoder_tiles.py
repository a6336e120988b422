"""K7's tensor-core instance on the CPU: its tile plan, its weight pack, its routing.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 9a). What surrounds it is held here: the map from a
128-row tile's rows to (sequence, token), emulated in PyTorch with the
kernel's block-diagonal attention, must reproduce the plain version and
cover every sequence exactly once; the 20 packed weight chunks must hold the
weights at the byte places the kernel reads; the layer's cached pack must
follow its weights as K1's does.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from onepose_plus_plus_tpu_torch.models.transformer import LoFTREncoderLayer
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import _elu_p1
from onepose_plus_plus_tpu_torch.ops.cuda_short_encoder import (
    TILE_ROWS,
    PackedShortEncoderWeights,
    fused_short_encoder_layer,
    fused_short_encoder_layer_packed,
    k7_instance,
    pack_short_weight_chunks,
    short_encoder_layer_plain,
    short_tile_plan,
    short_tile_rows,
)

torch.set_num_threads(2)

C, NHEAD = 128, 8
FINE_SHAPES = [(1, 1), (25, 25), (1, 25), (25, 1)]  # (L, S) of the fine transformer's four layers


def _weights(seed, c=C):
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale).astype(np.float32))
    return [t(c, c, scale=c ** -0.5), t(c, c, scale=c ** -0.5), t(c, c, scale=c ** -0.5),
            t(c, c, scale=c ** -0.5), 1 + t(c, scale=0.1), t(c, scale=0.1),
            t(2 * c, 2 * c, scale=(2 * c) ** -0.5), t(2 * c, c, scale=(2 * c) ** -0.5),
            1 + t(c, scale=0.1), t(c, scale=0.1)]


def _streams(seed, m, l, s):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, l, C)).astype(np.float32))
    return x, (x if l == s else torch.from_numpy(rng.standard_normal((m, s, C)).astype(np.float32)))


def _tiles_emulated(x, src, w, dtype):
    """The tensor-core kernel's arithmetic on its tiles, in PyTorch: gather each
    tile's x and source rows by :func:`short_tile_rows` (zero rows as padding),
    run the layer on the tile with the attention over all 128 source rows,
    masked to each row's own sequence, and scatter the x rows back."""
    m, l, c = x.shape
    s = src.shape[1]
    x_rows, src_rows, x_seq, src_seq = short_tile_rows(m, l, s)

    def gather(flat, rows):
        return torch.where((rows >= 0)[..., None], flat[rows.clamp_min(0)], torch.zeros(()))

    xt, st = gather(x.reshape(m * l, c), x_rows), gather(src.reshape(m * s, c), src_rows)
    r = lambda t: t.to(dtype).float()  # noqa: E731
    wq, wk, wv, wm, ln1s, ln1b, w0, w1, ln2s, ln2b = w
    wq, wk, wv, wm, w0, w1 = (r(a) for a in (wq, wk, wv, wm, w0, w1))
    n, hd = xt.shape[0], c // NHEAD
    q = r(_elu_p1(r(xt) @ wq)).view(n, TILE_ROWS, NHEAD, hd)
    k = r(_elu_p1(r(st) @ wk)).view(n, TILE_ROWS, NHEAD, hd)
    v = r(r(st) @ wv).view(n, TILE_ROWS, NHEAD, hd)
    same = (x_seq[:, :, None] == src_seq[:, None, :]) & (x_seq[:, :, None] >= 0)  # [tiles, rows, source rows]
    a = torch.einsum("trhd,tshd->thrs", q, k) * same[:, None]
    z = a.sum(-1).transpose(1, 2)[..., None]  # [tiles, rows, H, 1]
    msg = r((torch.einsum("thrs,tshd->trhd", r(a), v) / (z + 1e-6)).reshape(n, TILE_ROWS, c))
    h1 = F.layer_norm(msg @ wm, (c,), ln1s, ln1b, 1e-5)
    hidden = r(torch.relu(r(xt) @ w0[:c] + r(h1) @ w0[c:]))
    y = xt + F.layer_norm(hidden @ w1, (c,), ln2s, ln2b, 1e-5)
    out = torch.full((m * l, c), float("nan"))
    ok = x_rows >= 0
    out[x_rows[ok]] = y[ok]
    return out.reshape(m, l, c)


@pytest.mark.parametrize("m", [13, 37])
@pytest.mark.parametrize("l,s", FINE_SHAPES + [(32, 7), (128, 3)])
def test_tile_rows_give_every_sequence_exactly_once(m, l, s):
    """Each x row and each source row lies in exactly one tile, a tile holds
    whole sequences (its rows' sequences are consecutive, L or S rows each),
    and the padding rows are the tile's last ones."""
    g, n_tiles = short_tile_plan(m, l, s)
    assert g * l <= TILE_ROWS and g * s <= TILE_ROWS and (g + 1) * max(l, s) > TILE_ROWS
    x_rows, src_rows, x_seq, src_seq = short_tile_rows(m, l, s)
    assert x_rows.shape == (n_tiles, TILE_ROWS)
    for rows, seq, n in ((x_rows, x_seq, l), (src_rows, src_seq, s)):
        valid = rows >= 0
        assert torch.equal(torch.sort(rows[valid]).values, torch.arange(m * n))
        tile = torch.arange(n_tiles)[:, None].expand_as(rows)
        assert torch.equal(rows[valid] // n, g * tile[valid] + seq[valid])  # whole sequences, in order
        assert torch.equal(valid, torch.arange(TILE_ROWS) < valid.sum(1, keepdim=True))
    assert torch.equal(x_seq.amax(1), src_seq.amax(1))  # the same sequences on both sides


@pytest.mark.parametrize("m", [13, 37])
@pytest.mark.parametrize("l,s", FINE_SHAPES + [(32, 7)])
def test_tile_emulation_reproduces_the_plain_version(m, l, s):
    """The kernel's tiles, applied in PyTorch: f32 operands to summation order,
    bf16 operands within phase 9a's tolerance for the kernel itself."""
    x, src = _streams(l * 100 + s, m, l, s)
    w = _weights(3)
    got = _tiles_emulated(x, src, w, torch.float32)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, short_encoder_layer_plain(x, src, *w, nhead=NHEAD), rtol=0, atol=2e-5)
    got = _tiles_emulated(x, src, w, torch.bfloat16)
    d = (got - short_encoder_layer_plain(x, src, *w, nhead=NHEAD, dtype=torch.bfloat16)).abs()
    assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-4


def test_tile_plan_refuses_sequences_longer_than_a_tile():
    assert short_tile_plan(10, 129, 1) is None and short_tile_plan(10, 1, 129) is None
    assert short_tile_plan(8189, 25, 25) == (5, 1638) and short_tile_plan(8192, 1, 1) == (128, 64)


def test_pack_round_trip_at_c128():
    """The 20 chunks hold each weight at the byte the kernel reads: chunk q,
    element (n, k) at (n // 8) * 1024 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2,
    in the order K, V, Q, merge, FFN hidden by output half, FFN out."""
    w = _weights(4)
    wq, wk, wv, wm, _, _, w0, w1, _, _ = w
    chunks = pack_short_weight_chunks(wq, wk, wv, wm, w0, w1)
    assert chunks.dtype == torch.bfloat16 and chunks.shape == (20, 16, 8, 8, 8)
    flat = chunks.reshape(20, -1)
    n, k = torch.meshgrid(torch.arange(128), torch.arange(64), indexing="ij")
    byte = (n // 8) * 1024 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
    unpacked = flat[:, byte // 2]  # [20, 128 out, 64 in]
    order = [wk.t(), wv.t(), wq.t(), wm.t(), w0[:, :C].t(), w0[:, C:].t(), w1.t()]  # [out, in] each
    expect = torch.cat([m.reshape(C, -1, 64).transpose(0, 1) for m in order])
    assert torch.equal(unpacked, expect.to(torch.bfloat16))


@pytest.mark.parametrize("c,nhead,dtype,l,s,expected", [
    (128, 8, torch.bfloat16, 25, 25, "tc"),      # the fine transformer's four shapes
    (128, 8, torch.bfloat16, 1, 25, "tc"),
    (128, 8, torch.bfloat16, 128, 1, "tc"),      # one sequence fills a tile
    (128, 8, torch.bfloat16, 129, 1, "bf16"),    # longer than a tile: the CUDA cores
    (128, 4, torch.bfloat16, 25, 25, "bf16"),    # another head count
    (64, 8, torch.bfloat16, 25, 25, "bf16"),     # another width
    (128, 8, torch.float32, 25, 25, "f32"),      # f32 operands keep the CUDA-core kernel
])
def test_k7_instance(c, nhead, dtype, l, s, expected):
    assert k7_instance(c, nhead, dtype, l, s) == expected


def _layer(seed=0, dtype=torch.bfloat16):
    torch.manual_seed(seed)
    layer = LoFTREncoderLayer(C, NHEAD, "linear", dtype=dtype)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(np.random.default_rng(seed).standard_normal(p.shape).astype(np.float32))
                    * (0.05 if p.dim() == 2 else 1.0))
    return layer.eval()


def test_short_pack_gives_the_loose_result_and_is_kept():
    layer = _layer()
    x, src = _streams(1, 5, 25, 1)
    packed = layer.short_packed_weights()
    assert isinstance(packed, PackedShortEncoderWeights) and packed.dtype == torch.bfloat16
    assert packed.chunks is None  # chunk images exist only on the card
    assert layer.short_packed_weights() is packed
    a = fused_short_encoder_layer_packed(x, src, packed)
    b = fused_short_encoder_layer(x, src, *layer.kernel_weights(), nhead=NHEAD, dtype=torch.bfloat16)
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_short_pack_follows_load_state_dict():
    layer, other = _layer(0), _layer(1)
    first = layer.short_packed_weights()
    layer.load_state_dict(other.state_dict())
    second = layer.short_packed_weights()
    assert second is not first
    assert all(torch.equal(a, b) for a, b in zip(second.loose, other.short_packed_weights().loose))


@pytest.mark.parametrize("name", ["k_proj.weight", "mlp.0.weight", "norm1.weight"])
def test_short_pack_follows_an_in_place_update(name):
    layer = _layer()
    x, src = _streams(2, 4, 25, 25)
    first = layer.short_packed_weights()
    before = fused_short_encoder_layer_packed(x, src, first)
    with torch.no_grad():
        dict(layer.named_parameters())[name].add_(0.05)
    second = layer.short_packed_weights()
    assert second is not first
    after = fused_short_encoder_layer_packed(x, src, second)
    ref = fused_short_encoder_layer(x, src, *layer.kernel_weights(), nhead=NHEAD, dtype=torch.bfloat16)
    assert torch.equal(after, ref) and not torch.equal(after, before)


def test_short_pack_follows_a_dtype_change_and_is_not_kept_in_train_mode():
    layer = _layer()
    first = layer.short_packed_weights()
    layer.double()  # .to() replaces each parameter's storage
    assert layer.short_packed_weights() is not first
    assert layer.short_packed_weights().loose[0].dtype == torch.bfloat16  # the operand type
    layer.train()
    a, b = layer.short_packed_weights(), layer.short_packed_weights()
    assert a is not b
    layer.eval()
    assert layer.short_packed_weights() is layer.short_packed_weights()
