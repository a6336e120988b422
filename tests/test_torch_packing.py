"""What surrounds the redesigned kernels K1 and K4 and runs without a GPU: K4's
plain index preparation against a numpy stable sort (and a numpy rendering of
the index kernel's counting rule against both), K1's weight packing, the
packed-weights cache of ``LoFTREncoderLayer``, and which K1 instance (if any)
the model routes a layer to.
"""
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch.config import TransformerConfig
from onepose_plus_plus_tpu_torch.models.transformer import (
    LocalFeatureTransformer,
    LoFTREncoderLayer,
    routes_to_k1,
)
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (
    PackedEncoderWeights,
    fused_encoder_layer,
    fused_encoder_layer_packed,
    k1_instance,
    pack_encoder_weights,
    pack_weight_chunks,
    tcw_padded,
    tcw_takes,
)
from onepose_plus_plus_tpu_torch.ops.cuda_gather import (
    scatter_index,
    scatter_index_plain,
    window_scatter_plain,
)

torch.set_num_threads(2)


# ------------------------------------------------------------------ K4 index


def _ids(case: str) -> tuple:
    rng = np.random.default_rng(11)
    if case == "duplicates":
        ids = rng.integers(0, 12, (2, 64))
        n_cells = 12
    elif case == "negative_and_out_of_range":
        ids = rng.integers(-5, 25, (3, 96))
        n_cells = 16
    elif case == "k_not_a_multiple_of_32":
        ids = rng.integers(-2, 70, (2, 37))
        n_cells = 64
    elif case == "empty_batch_element":
        ids = rng.integers(0, 30, (3, 50))
        ids[1] = -1  # no valid slot at all
        n_cells = 30
    elif case == "train_shape":
        ids = rng.integers(0, 4096, (4, 1228))
        ids[:, 1028:] = ids[:, :200]  # GT slots repeat predicted cells
        ids[:, 1000:1028] = -1  # unfilled prediction slots
        n_cells = 4096
    else:
        raise ValueError(case)
    return ids.astype(np.int32), n_cells


CASES = ["duplicates", "negative_and_out_of_range", "k_not_a_multiple_of_32", "empty_batch_element",
         "train_shape"]


def _numpy_index(ids: np.ndarray, n_cells: int):
    key = np.where((ids >= 0) & (ids < n_cells), ids, n_cells)
    order = np.argsort(key, axis=1, kind="stable")
    sorted_key = np.take_along_axis(key, order, axis=1)
    cell_start = np.stack([np.searchsorted(row, np.arange(n_cells + 1), side="left") for row in sorted_key])
    return order, cell_start


@pytest.mark.parametrize("case", CASES)
def test_scatter_index_plain_matches_numpy_stable_sort(case):
    ids, n_cells = _ids(case)
    order, cell_start = scatter_index_plain(torch.from_numpy(ids), n_cells)
    ref_order, ref_start = _numpy_index(ids, n_cells)
    assert order.dtype == torch.int32 and cell_start.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), ref_order)
    np.testing.assert_array_equal(cell_start.numpy(), ref_start)
    # every valid slot lies in its cell's range, and the last entry counts them
    n_valid = ((ids >= 0) & (ids < n_cells)).sum(axis=1)
    np.testing.assert_array_equal(cell_start.numpy()[:, -1], n_valid)


@pytest.mark.parametrize("case", CASES)
def test_index_kernel_counting_rule_matches_plain(case):
    """The index kernel's rule, rendered in numpy: a slot's place is the number
    of slots with a smaller key plus the equal keys of smaller slot index; a
    cell's start is the number of slots with a smaller key."""
    ids, n_cells = _ids(case)
    key = np.where((ids >= 0) & (ids < n_cells), ids, n_cells).astype(np.int64)
    k = ids.shape[1]
    slot = np.arange(k)
    before = (key[:, None, :] < key[:, :, None]) | (
        (key[:, None, :] == key[:, :, None]) & (slot[None, None, :] < slot[None, :, None]))
    place = before.sum(axis=2)  # [n, k]
    order = np.empty_like(place)
    np.put_along_axis(order, place, np.broadcast_to(slot, place.shape), axis=1)
    cell_start = np.stack([(row[None, :] < np.arange(n_cells + 1)[:, None]).sum(axis=1) for row in key])
    ref_order, ref_start = scatter_index_plain(torch.from_numpy(ids), n_cells)
    np.testing.assert_array_equal(order, ref_order.numpy())
    np.testing.assert_array_equal(cell_start, ref_start.numpy())


def test_scatter_index_on_cpu_is_the_plain_version():
    ids, n_cells = _ids("negative_and_out_of_range")
    got = scatter_index(torch.from_numpy(ids), n_cells)
    ref = scatter_index_plain(torch.from_numpy(ids), n_cells)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_index_arrays_define_the_scatter_sum():
    """Walking each pixel's cells through order and cell_start, as the scatter
    kernel does, gives window_scatter_plain's map."""
    rng = np.random.default_rng(3)
    hc, wc, stride, window, c = 3, 4, 4, 5, 2
    h, w, half = stride * hc, stride * wc, window // 2
    ids = rng.integers(-2, hc * wc + 2, (2, 20)).astype(np.int32)
    ids[:, 10:14] = ids[:, :4]
    grad = rng.standard_normal((2, 20, window * window, c)).astype(np.float32)
    order, cell_start = (t.numpy() for t in scatter_index_plain(torch.from_numpy(ids), hc * wc))
    out = np.zeros((2, h, w, c), np.float32)
    for b in range(2):
        for r in range(h):
            for col in range(w):
                for ci in range(hc):
                    for cj in range(wc):
                        tr, tc = r - (stride * ci - half), col - (stride * cj - half)
                        if not (0 <= tr < window and 0 <= tc < window):
                            continue
                        cell = ci * wc + cj
                        for s in range(cell_start[b, cell], cell_start[b, cell + 1]):
                            out[b, r, col] += grad[b, order[b, s], tr * window + tc]
    ref = window_scatter_plain(torch.from_numpy(grad), torch.from_numpy(ids), (hc, wc), stride, window, (h, w))
    np.testing.assert_allclose(out, ref.numpy(), atol=1e-5)


# ---------------------------------------------------------------- K1 packing


def unpack_weight_chunks(chunks: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_weight_chunks: [K / 64, N / 8, 8, 8, 8] -> [N, K]."""
    n_chunks, ng = chunks.shape[:2]
    return chunks.permute(1, 3, 0, 2, 4).reshape(ng * 8, n_chunks * 64)


@pytest.mark.parametrize("n,k", [(256, 256), (256, 512), (8, 64), (40, 128)])
def test_pack_weight_chunks_layout_and_round_trip(n, k):
    """Element (n, k) of chunk k // 64 lies at the byte the kernel's shared-memory
    descriptor expects; unpacking restores the matrix."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(torch.bfloat16)
    chunks = pack_weight_chunks(w)
    assert chunks.shape == (k // 64, n // 8, 8, 8, 8) and chunks.is_contiguous()
    assert torch.equal(unpack_weight_chunks(chunks), w)
    flat = chunks.reshape(k // 64, -1)
    for row, col in ((0, 0), (n - 1, k - 1), (n // 2 + 3, k // 2 + 5), (7, 63), (n - 8, 64 % k)):
        kk = col % 64
        byte = (row // 8) * 1024 + (kk // 8) * 128 + (row % 8) * 16 + (kk % 8) * 2
        assert flat[col // 64, byte // 2] == w[row, col]


def test_pack_weight_chunks_rejects_other_shapes():
    with pytest.raises(ValueError):
        pack_weight_chunks(torch.zeros(12, 64))
    with pytest.raises(ValueError):
        pack_weight_chunks(torch.zeros(16, 96))


def _layer(seed=0, c=64, nhead=8, dtype=torch.float32):
    torch.manual_seed(seed)
    layer = LoFTREncoderLayer(c, nhead, "linear", dtype=dtype)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(np.random.default_rng(seed).standard_normal(p.shape).astype(np.float32))
                    * (0.1 if p.dim() == 2 else 1.0))
    return layer.eval()


def _streams(c=64, l=33, s=21, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, l, c)).astype(np.float32))
    src = torch.from_numpy(rng.standard_normal((2, s, c)).astype(np.float32))
    xm = torch.from_numpy((rng.random((2, l)) > 0.3).astype(np.float32))
    sm = torch.from_numpy((rng.random((2, s)) > 0.3).astype(np.float32))
    return x, src, xm, sm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weights_give_the_loose_result(dtype):
    """The packed entry equals the loose one through the plain version, bit for bit."""
    layer = _layer(dtype=dtype)
    x, src, xm, sm = _streams()
    packed = layer.packed_weights()
    assert isinstance(packed, PackedEncoderWeights) and packed.dtype == dtype
    assert packed.stats is None and packed.apply is None  # chunk images exist only on the card
    with torch.no_grad():
        a = fused_encoder_layer_packed(x, src, packed, xm, sm)
        b = fused_encoder_layer(x, src, *layer.kernel_weights(), xm, sm, nhead=8, dtype=dtype)
        c = layer(x, src, xm, sm, fused=True)
    assert a.dtype == torch.float32
    assert torch.equal(a, b) and torch.equal(a, c)


def test_packed_weights_are_kept_between_calls():
    layer = _layer()
    assert layer.packed_weights() is layer.packed_weights()


def test_packed_weights_follow_load_state_dict():
    layer, other = _layer(seed=0), _layer(seed=1)
    x, src, xm, sm = _streams()
    first = layer.packed_weights()
    with torch.no_grad():
        before = layer(x, src, xm, sm, fused=True)
    layer.load_state_dict(other.state_dict())
    assert layer.packed_weights() is not first
    with torch.no_grad():
        after = layer(x, src, xm, sm, fused=True)
        ref = other(x, src, xm, sm, fused=True)
    assert torch.equal(after, ref) and not torch.equal(after, before)


@pytest.mark.parametrize("name", ["q_proj.weight", "mlp.2.weight", "norm2.bias"])
def test_packed_weights_follow_an_in_place_update(name):
    """An optimizer step updates a parameter in place: the cache must not serve the old weights."""
    layer = _layer()
    x, src, xm, sm = _streams()
    first = layer.packed_weights()
    with torch.no_grad():
        before = layer(x, src, xm, sm, fused=True)
        dict(layer.named_parameters())[name].add_(0.05)
    assert layer.packed_weights() is not first
    with torch.no_grad():
        after = layer(x, src, xm, sm, fused=True)
        ref = fused_encoder_layer(x, src, *layer.kernel_weights(), xm, sm, nhead=8)
    assert torch.equal(after, ref) and not torch.equal(after, before)


def test_packed_weights_follow_a_dtype_change_of_the_module():
    layer = _layer()
    first = layer.packed_weights()
    layer.double()  # .to() replaces each parameter's storage
    second = layer.packed_weights()
    assert second is not first
    assert second.loose[0].dtype == torch.float32  # still cast to the operand type


def test_packed_weights_are_not_kept_in_train_mode():
    layer = _layer().train()
    a, b = layer.packed_weights(), layer.packed_weights()
    assert a is not b and layer._packed is None
    layer.eval()
    assert layer.packed_weights() is layer.packed_weights()


def test_bf16_operands_of_another_width_run_the_plain_version_on_the_cpu():
    """The tensor-core instance's width limit is a limit of the CUDA route only."""
    layer = _layer(c=32, dtype=torch.bfloat16)
    x, src, xm, sm = _streams(c=32)
    with torch.no_grad():
        out = layer(x, src, xm, sm, fused=True)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_pack_encoder_weights_rejects_wrong_shapes_and_types():
    layer = _layer()
    w = list(layer.kernel_weights())
    with pytest.raises(ValueError):
        pack_encoder_weights(*w, nhead=8, dtype=torch.float16)
    w[6] = w[6][:, :-1]
    with pytest.raises(ValueError):
        pack_encoder_weights(*w, nhead=8)


# ---------------------------------------------------------------- K1 routing


@pytest.mark.parametrize("c,nhead,dtype,expected", [
    (256, 8, "bfloat16", "tc"),     # both coarse transformers of the bf16 configurations
    (64, 8, "bfloat16", "tcw"),     # the narrow test configurations: the bf16 chain, C padded to 64 channels
    (256, 4, "bfloat16", "tcw"),    # the 256-channel instance's width with other heads: the chain
    (224, 8, "bfloat16", "tcw"),    # not a multiple of 64, head width 28: replicated denominators
    (64, 8, "float32", "tcw_tf32"),
    (256, 8, "float32", "tf32x3"),  # the demo's coarse width: tensor cores in split TF32
    (48, 8, "bfloat16", None),      # not a multiple of 32
    (288, 8, "float32", "tcw_tf32"),  # above 256: the chains reach 4096
    (384, 8, "bfloat16", "tcw"),    # the JAX kernel's widths above 256
    (512, 8, "float32", "tcw_tf32"),  # f32 at the JAX kernel's other widths: tensor cores in split TF32
    (544, 8, "float32", "tcw_tf32"),  # not a multiple of 64: the last k chunk partial
    (512, 4, "float32", "tcw_tf32"),  # a [C, C / heads + 1] table of 128-wide heads
    (128, 16, "float32", "tcw_tf32"),  # head width 8: 16 heads a 128-column attention block
    (128, 16, "bfloat16", "tcw"),
    (384, 16, "float32", "tcw_tf32"),  # head width 24: heads straddle 32-channel chunks
    (96, 1, "float32", "tcw_tf32"),  # below 128
    (640, 160, "float32", "tcw_tf32"),  # head width 4: replicated denominators
    (4128, 8, "float32", None),     # above 4096
    (96, 5, "bfloat16", None),      # heads do not divide C
])
def test_k1_instance_and_the_models_routing_agree(monkeypatch, c, nhead, dtype, expected):
    """k1_instance names the instance; the model turns K1 on by the JAX rule
    alone (inference, linear attention, both streams >= 256 tokens) at every
    width, so that a width no instance takes reaches the wrapper, which raises
    on the card, and never runs the eager layer there."""
    assert k1_instance(c, nhead, {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]) == expected
    cfg = TransformerConfig(d_model=c, nhead=nhead, compute_dtype=dtype, layer_iter_n=1)
    assert routes_to_k1(cfg, False, 300, 256)
    assert not routes_to_k1(cfg, True, 300, 256) and not routes_to_k1(cfg, False, 300, 255)
    seen = []
    monkeypatch.setattr(LoFTREncoderLayer, "forward",
                        lambda self, x, source, xm=None, sm=None, fused=False: seen.append(fused) or x)
    model = LocalFeatureTransformer(cfg).eval()
    model(torch.zeros(1, 300, c), torch.zeros(1, 256, c))
    assert seen == [True] * 4  # one (self, cross) pair over two streams


def _other_instance(c, nhead, dtype):
    """The instance of a width other than (256, 8): the tensor-core chain of the
    operand type, at every width K1 takes."""
    return "tcw_tf32" if dtype == torch.float32 else "tcw"


TCW_WIDTHS = [(128, 8), (256, 4), (384, 8), (512, 8), (512, 1), (640, 8), (768, 8), (1024, 8), (2048, 16),
              (4096, 16), (4096, 32)]
# the widths the chains took from the CUDA-core kernels: C below 128 or not a
# multiple of 64, head widths that are not a multiple of 16 (bf16) or 8 (f32)
NARROW_BF16_WIDTHS = [(32, 1), (64, 8), (64, 1), (96, 2), (128, 16), (192, 8), (224, 8), (256, 32),
                      (320, 40), (640, 16), (4096, 512)]
NARROW_F32_WIDTHS = [(32, 1), (64, 8), (64, 1), (96, 2), (224, 8), (288, 8), (640, 160), (4064, 8)]


def _meta_weights(c):
    ww = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    return (ww(c, c), ww(c, c), ww(c, c), ww(c, c), ww(c), ww(c), ww(2 * c, 2 * c), ww(2 * c, c), ww(c), ww(c))


@pytest.mark.parametrize("c,nhead", TCW_WIDTHS + NARROW_BF16_WIDTHS)
def test_k1_tcw_routing_and_packing_agree(c, nhead):
    """bf16 operands take the tensor-core chain at every width but (256, 8),
    the JAX kernel's and the narrower ones alike, so no width starts or stops
    to raise. The model routes every one of them to K1, and the packing (run
    on meta tensors: the CPU keeps the loose weights) names the same instance
    and packs the chain's chunks, input columns padded to Cp (C to a multiple
    of 64): [Wk; Wv] as ceil(2C / 128) column blocks of Cp / 64 chunks, then
    Wq, Wmerge (ceil(C / 128) blocks of Cp / 64), W0 (ceil(2C / 128) blocks of
    2 Cp / 64), W1 (ceil(C / 128) blocks of 2C / 64)."""
    assert k1_instance(c, nhead, torch.bfloat16) == "tcw" and tcw_takes(c, nhead)
    assert k1_instance(c, nhead, torch.float32) == "tcw_tf32"
    cfg = TransformerConfig(d_model=c, nhead=nhead, compute_dtype="bfloat16", layer_iter_n=1)
    assert routes_to_k1(cfg, False, 256, 300)
    packed = pack_encoder_weights(*_meta_weights(c), nhead=nhead, dtype=torch.bfloat16)
    assert packed.instance == "tcw" and packed.width == c
    nb, nb2, kc, kh = -(-c // 128), -(-2 * c // 128), tcw_padded(c) // 64, 2 * c // 64
    assert packed.loose == () and packed.stats.shape == (nb2, kc, 16, 8, 8, 8)
    assert packed.apply.numel() == (2 * nb * kc + nb2 * 2 * kc + nb * kh) * 128 * 64


@pytest.mark.parametrize("c,nhead", TCW_WIDTHS + NARROW_BF16_WIDTHS + NARROW_F32_WIDTHS)
def test_k1_tcw_tf32_routing_and_packing_agree(c, nhead):
    """f32 operands take the split-TF32 chain at every width but (256, 8); the
    model routes every width to K1, and the packing (meta tensors) names the
    same instance and packs its chunks of [128 out, 32 in], hi and lo, input
    columns padded to Cp (C to a multiple of 64, an even chunk count): [Wk; Wv]
    as ceil(2C / 128) column blocks of Cp / 32 chunks, then Wq, Wmerge, W0,
    W1."""
    assert k1_instance(c, nhead, torch.float32) == "tcw_tf32" and tcw_takes(c, nhead)
    cfg = TransformerConfig(d_model=c, nhead=nhead, compute_dtype="float32", layer_iter_n=1)
    assert routes_to_k1(cfg, False, 256, 300)
    packed = pack_encoder_weights(*_meta_weights(c), nhead=nhead, dtype=torch.float32)
    assert packed.instance == "tcw_tf32" and packed.width == c
    nb, nb2, kc, kh = -(-c // 128), -(-2 * c // 128), tcw_padded(c) // 32, 2 * c // 32
    assert kc % 2 == 0 and kh % 2 == 0  # the split-TF32 loop takes chunks in pairs
    assert packed.loose == () and packed.stats.shape == (nb2, kc, 2, 16, 8, 8, 4)
    assert packed.apply.numel() == (2 * nb * kc + nb2 * 2 * kc + nb * kh) * 2 * 128 * 32


def test_k1_instance_reads_the_f32_rule_at_every_width():
    """Every (C, heads) K1 takes in f32 (C a multiple of 32 up to 4096, heads
    dividing C) runs on the tensor cores in split TF32: "tf32x3" at (256, 8),
    "tcw_tf32" at the other 2469; both dtypes name an instance at exactly the
    same pairs."""
    seen = {"tf32x3": 0, "tcw_tf32": 0}
    for c in range(32, 4097, 32):
        for nhead in range(1, c + 1):
            if c % nhead:
                continue
            got = k1_instance(c, nhead, torch.float32)
            want = "tf32x3" if (c, nhead) == (256, 8) else "tcw_tf32"
            assert got == want, (c, nhead, got)
            assert k1_instance(c, nhead, torch.bfloat16) == ("tc" if got == "tf32x3" else "tcw")
            seen[got] += 1
    assert seen == {"tf32x3": 1, "tcw_tf32": 2469}, seen


def _jax_widths(c_max):
    """Every (C, nhead) the JAX kernel takes up to C = c_max: C % 128 == 0 and a
    head width C / nhead that is a multiple of 8 (``pallas_encoder.py::fused_encoder_layer``)."""
    return [(c, nhead) for c in range(128, c_max + 1, 128) for nhead in range(1, c + 1)
            if c % nhead == 0 and (c // nhead) % 8 == 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_instance_takes_every_width_of_the_jax_kernel_up_to_512(dtype):
    """Up to C = 512, K1 has an instance for every (C, nhead) the JAX kernel
    takes, the wide heads (head widths of 128 and more at C = 512, 192 at
    C = 384, 256 at C = 256) included."""
    seen = [(c, nhead, k1_instance(c, nhead, dtype)) for c, nhead in _jax_widths(512)]
    assert all(got is not None for _, _, got in seen), [(c, n) for c, n, g in seen if g is None]
    assert ("tc" if dtype == torch.bfloat16 else "tf32x3") in {g for c, n, g in seen if (c, n) == (256, 8)}
    for c, nhead, got in seen:
        if (c, nhead) != (256, 8):
            assert got == _other_instance(c, nhead, dtype), (c, nhead, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_instance_takes_every_width_of_the_jax_kernel_up_to_2048(dtype):
    """Above 512 too: every (C, nhead) the JAX kernel takes up to C = 2048 (170
    pairs) has a tensor-core instance (f32: the split-TF32 chain; bf16: the
    bf16 chain, head widths 8 and 24 included), and the model routes each to K1
    by the JAX rule, so that no such width reaches a wrapper that raises."""
    widths = _jax_widths(2048)
    assert len(widths) == 170
    tc = "tc" if dtype == torch.bfloat16 else "tf32x3"
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    for c, nhead in widths:
        want = tc if (c, nhead) == (256, 8) else _other_instance(c, nhead, dtype)
        assert k1_instance(c, nhead, dtype) == want, (c, nhead)
        cfg = TransformerConfig(d_model=c, nhead=nhead, compute_dtype=name, layer_iter_n=1)
        assert routes_to_k1(cfg, False, 256, 300) and not routes_to_k1(cfg, True, 256, 300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_instance_takes_every_width_of_the_jax_kernel_up_to_4096(dtype):
    """Every (C, nhead) the JAX kernel takes up to C = 4096 (the widest K1
    layer) runs on the tensor cores: "tc" / "tf32x3" at (256, 8), the chain of
    the operand type at the rest."""
    widths = _jax_widths(4096)
    tc = "tc" if dtype == torch.bfloat16 else "tf32x3"
    got = {(c, nhead): k1_instance(c, nhead, dtype) for c, nhead in widths}
    assert got.pop((256, 8)) == tc
    assert set(got.values()) == {_other_instance(0, 1, dtype)}, {k: v for k, v in got.items() if v is None}
    assert any((c // nhead) % 16 == 8 for c, nhead in got)  # head widths 8, 24, ...: the 16 sum rows
