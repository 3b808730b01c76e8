"""The port's BranchyAlexNet, its graph and its synthetic data against the JAX
package's, on the CPU, on the reference's parameters (converted by
``alexnet_params_from_numpy``) and inputs drawn from numpy seeds.

* structure: branch lengths 12, 16, 19, 20 and 22; every layer's spec,
  shapes and Table-I features equal the reference's;
* every layer of every branch, from the reference's own input to it, within
  atol 1e-5 + rtol 1e-5 of ``repro.models.alexnet.apply_layer``; the
  asymmetric ``"SAME"`` max-pool padding and the LRN formula each have a
  case of their own;
* per-exit logits, chained through the branch, within 1e-4, with equal
  predictions except where the reference's top-2 margin is below 1e-4;
* ``loss`` with every dropout rate at 0 (so the reference's mask is all
  ones) within 1e-5 of the reference's, ``accuracy`` equal, gradients
  finite;
* ``alexnet_graph``: names, kinds, features, ``out_bytes``, payloads and
  ``cut_bytes`` of every (exit, partition) equal the reference's;
* ``cifar_like`` / ``token_stream`` (and their batch iterators) byte-equal
  to the reference's for the same numpy seed.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_alexnet_config as ref_get_alexnet_config
from repro.core import graph as ref_graph
from repro.data import synthetic as ref_syn
from repro.models import alexnet as ref_alex
from repro_torch.configs import get_alexnet_config
from repro_torch.core import alexnet_graph
from repro_torch.data import synthetic
from repro_torch.models import alexnet
from repro_torch.models.convert import alexnet_params_from_numpy

LAYER_ATOL = LAYER_RTOL = 1e-5
LOGIT_TOL = 1e-4
MARGIN_TOL = 1e-4
LOSS_TOL = 1e-5
EXITS = (1, 2, 3, 4, 5)


@pytest.fixture(scope="module")
def ref_net(alexnet_setup):
    return alexnet_setup[0]


@pytest.fixture(scope="module")
def ref_params(alexnet_setup):
    """The reference's parameters (``conftest.alexnet_setup``: seed 0 of
    ``jax.random``) as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, alexnet_setup[1])


@pytest.fixture(scope="module")
def port(ref_params):
    net = alexnet.BranchyAlexNet(alexnet.BranchyAlexNetConfig())
    return net, alexnet_params_from_numpy(ref_params, device="cpu")


@pytest.fixture(scope="module")
def images():
    x, y = ref_syn.cifar_like(np.random.default_rng(5), 16, noise=1.4)
    return x, y


@pytest.fixture(scope="module")
def ref_layer_io(ref_net, ref_params, images):
    """Per exit: the reference's (input, output) of every layer of the
    branch, chained from the images."""
    x = images[0]
    out = {}
    for e in EXITS:
        h, io = x, []
        for spec in ref_net.branch_layers(e):
            y = np.asarray(ref_alex.apply_layer(spec, ref_params.get(spec.name, {}), h))
            io.append((spec, h, y))
            h = y
        out[e] = io
    return out


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _held_predictions(ref_logits, port_logits):
    """Predictions equal except where the reference's top-2 margin is below
    MARGIN_TOL; every flip is reported with its margin."""
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    ref_pred, port_pred = ref_logits.argmax(-1), port_logits.argmax(-1)
    flips = [(i, float(margins[i])) for i in np.nonzero(ref_pred != port_pred)[0]]
    for i, m in flips:
        print(f"prediction flip at row {i}: reference top-2 margin {m:.3e}")
    assert all(m < MARGIN_TOL for _, m in flips), flips


# ------------------------------------------------------------- structure
def test_config_matches_reference():
    assert dataclasses.asdict(get_alexnet_config()) == \
        dataclasses.asdict(ref_get_alexnet_config())


def test_branch_structure_matches_reference(ref_net, port):
    net, _ = port
    assert [len(net.branch_layers(e)) for e in EXITS] == [12, 16, 19, 20, 22]
    assert net.num_exits == ref_net.num_exits == 5
    for e in EXITS:
        assert [dataclasses.asdict(s) for s in net.branch_layers(e)] == \
            [dataclasses.asdict(s) for s in ref_net.branch_layers(e)]
        assert net.branch_shapes(e) == ref_net.branch_shapes(e)
        for spec, (in_shape, _) in zip(net.branch_layers(e), net.branch_shapes(e)):
            assert alexnet.layer_features(spec, in_shape) == \
                ref_alex.layer_features(spec, in_shape)


def test_init_draws_reference_shapes_from_the_generator(ref_params):
    """``init`` draws every leaf from the generator with the reference's
    shapes (conv OIHW), scales and zero biases; the same seed gives the
    same parameters."""
    net = alexnet.BranchyAlexNet(alexnet.BranchyAlexNetConfig())
    a = net.init(torch.Generator().manual_seed(0), device="cpu")
    b = net.init(torch.Generator().manual_seed(0), device="cpu")
    conv = alexnet_params_from_numpy(ref_params, device="cpu")
    assert a.keys() == conv.keys()
    for name in a:
        assert a[name].keys() == conv[name].keys()
        for k in a[name]:
            assert a[name][k].shape == conv[name][k].shape
            assert a[name][k].dtype == torch.float32
            assert torch.equal(a[name][k], b[name][k])
        if "w" in a[name]:
            w = a[name]["w"]
            fan_in = w[0].numel() if w.ndim == 4 else w.shape[0]
            assert float(w.std()) == pytest.approx(1 / math.sqrt(fan_in), rel=0.15)
            assert not a[name]["b"].any()
            if w.ndim == 4:
                assert w.is_contiguous(memory_format=torch.channels_last)


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = alexnet.BranchyAlexNet(alexnet.BranchyAlexNetConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        net.init(torch.Generator().manual_seed(0))


def test_conv_weights_convert_hwio_to_oihw(ref_params):
    conv = alexnet_params_from_numpy(ref_params, device="cpu")
    w = ref_params["conv2"]["w"]                      # [f, f, in, out]
    assert conv["conv2"]["w"].shape == (64, 32, 5, 5)
    np.testing.assert_array_equal(conv["conv2"]["w"].numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))
    np.testing.assert_array_equal(conv["fc1"]["w"].numpy(), ref_params["fc1"]["w"])


# ---------------------------------------------------------- single layers
@pytest.mark.parametrize("exit_idx", EXITS)
def test_every_layer_matches_reference(port, ref_layer_io, exit_idx):
    _, params = port
    for spec, x, want in ref_layer_io[exit_idx]:
        got = alexnet.apply_layer(spec, params.get(spec.name, {}), _t(x))
        assert got.shape == want.shape, spec.name
        np.testing.assert_allclose(got.numpy(), want, atol=LAYER_ATOL,
                                   rtol=LAYER_RTOL, err_msg=spec.name)


@pytest.mark.parametrize("size", [32, 16, 8, 7])
def test_max_pool_pads_same_asymmetrically(size):
    """The 3x3 stride-2 pool pads TF-style: 0 before and 1 after on even
    sizes (1 and 1 on odd ones), with -inf; torch's symmetric padding is a
    different function."""
    assert alexnet.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32) - 3.0
    spec = alexnet.LayerSpec("pool", "pool", filt=3, stride=2)
    got = alexnet.apply_layer(spec, {}, _t(x)).numpy()
    want = np.asarray(ref_alex.apply_layer(spec, {}, x))
    np.testing.assert_array_equal(got, want)
    # the same window in numpy: rows [2i - before, 2i - before + 3)
    before = alexnet.same_pads(size, 3, 2)[0]
    out = -(-size // 2)
    direct = np.full((2, out, out, 4), -np.inf, np.float32)
    for i in range(out):
        for j in range(out):
            r0, c0 = 2 * i - before, 2 * j - before
            win = x[:, max(r0, 0):r0 + 3, max(c0, 0):c0 + 3]
            direct[:, i, j] = win.max(axis=(1, 2))
    np.testing.assert_array_equal(got, direct)
    if size % 2 == 0:
        sym = F.max_pool2d(_t(x).permute(0, 3, 1, 2), 3, 2, padding=1)
        assert not np.array_equal(sym.permute(0, 2, 3, 1).numpy(), got)


def test_lrn_formula():
    """x / (2 + 1e-4 * sum of x^2 over a zero-padded 5-channel window)^0.75:
    the reference's layer, the formula in float64, and torch's
    ``local_response_norm`` with alpha 5e-4 (it divides alpha by the window
    size), k 2 and beta 0.75."""
    rng = np.random.default_rng(3)
    x = (30.0 * rng.normal(size=(2, 6, 6, 9))).astype(np.float32)
    spec = alexnet.LayerSpec("lrn", "lrn")
    got = alexnet.apply_layer(spec, {}, _t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_alex.apply_layer(spec, {}, x)),
                               rtol=1e-6, atol=1e-6)
    x64 = x.astype(np.float64)
    sq = np.pad(x64 ** 2, [(0, 0)] * 3 + [(2, 2)])
    summed = sum(sq[..., i:i + x.shape[-1]] for i in range(5))
    np.testing.assert_allclose(got, x64 / (2.0 + 1e-4 * summed) ** 0.75,
                               rtol=1e-6, atol=1e-6)
    lib = F.local_response_norm(_t(x).permute(0, 3, 1, 2), 5, alpha=5e-4,
                                beta=0.75, k=2.0).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, lib.numpy(), rtol=1e-5, atol=1e-6)
    # the window term matters at this scale
    assert np.abs(got - x64 / 2.0 ** 0.75).max() > 1.0


def test_dropout_draws_from_the_generator():
    spec = alexnet.LayerSpec("drop", "dropout", drop_rate=0.5)
    x = torch.ones((4, 256))
    assert alexnet.apply_layer(spec, {}, x) is x           # inference
    a = alexnet.apply_layer(spec, {}, x, train=True,
                            generator=torch.Generator().manual_seed(1))
    b = alexnet.apply_layer(spec, {}, x, train=True,
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < float((a > 0).float().mean()) < 0.6
    with pytest.raises(ValueError, match="generator"):
        alexnet.apply_layer(spec, {}, x, train=True)


# ------------------------------------------------------------- exits
@pytest.mark.parametrize("exit_idx", EXITS)
def test_exit_logits_match_reference(port, ref_layer_io, images, exit_idx):
    net, params = port
    want = ref_layer_io[exit_idx][-1][2]
    got = net.forward_exit(params, _t(images[0]), exit_idx).numpy()
    assert got.shape == want.shape == (16, 10)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    _held_predictions(want, got)
    all_exits = net.forward_all(params, _t(images[0]))
    assert torch.equal(all_exits[exit_idx - 1], torch.from_numpy(got))


def _no_dropout(net):
    net.main = [dataclasses.replace(s, drop_rate=0.0) for s in net.main]
    net.sides = [(p, [dataclasses.replace(s, drop_rate=0.0) for s in side])
                 for p, side in net.sides]
    return net


def test_loss_and_accuracy_match_reference(ref_params, images):
    x, y = images
    ref_net = _no_dropout(ref_alex.BranchyAlexNet(ref_alex.BranchyAlexNetConfig()))
    net = _no_dropout(alexnet.BranchyAlexNet(alexnet.BranchyAlexNetConfig()))
    params = alexnet_params_from_numpy(ref_params, device="cpu")
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_(True)
    want = float(ref_net.loss(ref_params, (x, y), jax.random.key(2)))
    got = net.loss(params, (_t(x), _t(y)), torch.Generator().manual_seed(2))
    assert float(got.detach()) == pytest.approx(want, abs=LOSS_TOL)
    got.backward()
    grads = [t.grad for layer in params.values() for t in layer.values()]
    assert grads and all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(g.abs().sum() > 0 for g in grads)
    with torch.no_grad():
        for e in EXITS:
            assert float(net.accuracy(params, _t(x), _t(y), e)) == \
                float(ref_net.accuracy(ref_params, x, y, e))


# ------------------------------------------------------------- graph
@pytest.mark.parametrize("batch,dtype_bytes", [(1, 4), (4, 2)])
def test_graph_matches_reference(ref_net, port, batch, dtype_bytes):
    net, _ = port
    rg = ref_graph.alexnet_graph(ref_net, batch=batch, dtype_bytes=dtype_bytes)
    pg = alexnet_graph(net, batch=batch, dtype_bytes=dtype_bytes)
    assert (pg.name, pg.accuracy, pg.input_bytes, pg.result_bytes) == \
        (rg.name, rg.accuracy, rg.input_bytes, rg.result_bytes)
    assert pg.num_exits == rg.num_exits == 5
    for e, (rb, pb) in enumerate(zip(rg.branches, pg.branches), start=1):
        assert [(l.name, l.kind, l.features, l.out_bytes, l.state_bytes)
                for l in pb] == \
            [(l.name, l.kind, l.features, l.out_bytes, l.state_bytes) for l in rb]
        for p in range(len(pb) + 1):
            assert pg.cut_bytes(e, p) == rg.cut_bytes(e, p)


def test_graph_layers_run_the_model(port, ref_layer_io):
    """A graph layer's ``run`` is ``apply_layer`` on its input's device."""
    net, params = port
    g = alexnet_graph(net)
    for layer, (spec, x, _) in zip(g.branches[0], ref_layer_io[1]):
        assert layer.name == spec.name
        want = alexnet.apply_layer(spec, params.get(spec.name, {}), _t(x))
        got = layer.run(params, _t(x))
        assert got.device == want.device and torch.equal(got, want)


# ------------------------------------------------------------- data
@pytest.mark.parametrize("seed,num,noise", [(0, 5, 0.7), (99, 33, 1.4)])
def test_cifar_like_equals_reference_bytes(seed, num, noise):
    a = synthetic.cifar_like(np.random.default_rng(seed), num, noise=noise)
    b = ref_syn.cifar_like(np.random.default_rng(seed), num, noise=noise)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes()
    it_a, it_b = synthetic.cifar_batches(7, 4), ref_syn.cifar_batches(7, 4)
    for _ in range(2):
        for u, v in zip(next(it_a), next(it_b)):
            assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("seed,batch,seq,vocab", [(0, 2, 9, 50), (3, 4, 16, 257)])
def test_token_stream_equals_reference_bytes(seed, batch, seq, vocab):
    a = synthetic.token_stream(np.random.default_rng(seed), batch, seq, vocab)
    b = ref_syn.token_stream(np.random.default_rng(seed), batch, seq, vocab)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    it_a = synthetic.token_batches(seed, batch, seq, vocab)
    it_b = ref_syn.token_batches(seed, batch, seq, vocab)
    for _ in range(2):
        assert next(it_a).tobytes() == next(it_b).tobytes()
