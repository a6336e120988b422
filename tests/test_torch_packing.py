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
    (64, 8, "bfloat16", "bf16"),    # the narrow test configurations: CUDA cores, bf16 operands
    (256, 4, "bfloat16", "bf16"),   # the tensor-core instance's width with other heads
    (224, 8, "bfloat16", "bf16"),
    (64, 8, "float32", "f32"),
    (256, 8, "float32", "f32"),
    (48, 8, "bfloat16", None),      # not a multiple of 32
    (288, 8, "float32", None),      # above 256
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
