"""The port's alternate models (the no-CNN biLSTM, the transformer and the
legacy polish Seq2Seq) and `rnn.lstm_with_state` against the JAX package's,
on the same numpy weights and inputs (f32 on the CPU), at the tolerance of
tests/test_models.py (2e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models import polish_seq2seq as jax_s2s
from pepper_tpu.models import rnn as jax_rnn
from pepper_tpu.models import variant_no_cnn as jax_no_cnn
from pepper_tpu.models import variant_transformer as jax_tf
from pepper_tpu_torch.models import polish_seq2seq as s2s
from pepper_tpu_torch.models import rnn
from pepper_tpu_torch.models import variant_no_cnn as no_cnn
from pepper_tpu_torch.models import variant_transformer as tf
from pepper_tpu_torch.models.checkpoint import params_from_jax

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The step loops issue many tiny ops; one intra-op thread per test
    worker keeps the file's run time the same under load as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(np.shape(v))
    return out


def _random_batchnorm(tree, rng):
    """Give every BatchNorm non-trivial running statistics and affine
    parameters, so the eps and the normalisation are exercised."""
    for k, v in tree.items():
        if isinstance(v, dict) and "running_var" in v:
            shape = v["running_var"].shape
            v["running_mean"] = rng.normal(0, 0.5, shape).astype(np.float32)
            v["running_var"] = rng.uniform(0.2, 1.0, shape).astype(
                np.float32)
            v["weight"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            v["bias"] = rng.normal(0, 0.2, shape).astype(np.float32)
        elif isinstance(v, dict):
            _random_batchnorm(v, rng)
    return tree


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


# ----------------------------------------------------------- lstm_with_state
def test_lstm_with_state_matches_jax_and_zero_state_keeps_lstm_bits():
    rng = np.random.default_rng(0)
    B, T, F, H = 3, 7, 6, 8
    tree = _numpy(jax_rnn.init_rnn_params(jax.random.PRNGKey(1), F, H, 4))
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    h0 = rng.normal(size=(B, 2, H)).astype(np.float32)
    c0 = rng.normal(size=(B, 2, H)).astype(np.float32)
    want = jax_rnn.lstm_with_state(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.asarray(x), jnp.asarray(h0),
                                   jnp.asarray(c0))
    p = params_from_jax(tree)
    got = rnn.lstm_with_state(p, torch.from_numpy(x), torch.from_numpy(h0),
                              torch.from_numpy(c0))
    assert [tuple(t.shape) for t in got] == [(B, T, 2 * H), (B, 2, H),
                                             (B, 2, H)]
    for g, w in zip(got, want):
        _close(g, w)
    zeros = torch.zeros((B, 2, H))
    out0, _, _ = rnn.lstm_with_state(p, torch.from_numpy(x), zeros, zeros)
    assert torch.equal(out0, rnn.lstm(p, torch.from_numpy(x)))


# ------------------------------------------------------------------ no-CNN
@pytest.mark.parametrize("train_mode", [False, True])
def test_no_cnn_forward_matches_jax(train_mode):
    rng = np.random.default_rng(1)
    B, W, F, H = 3, 9, 10, 16
    tree = _numpy(jax_no_cnn.init_no_cnn_params(
        jax.random.PRNGKey(2), image_features=F, window=W, hidden=H))
    x = rng.integers(-50, 50, (B, W, F)).astype(np.float32)
    h = rng.normal(size=(B, 2, H)).astype(np.float32)
    c = rng.normal(size=(B, 2, H)).astype(np.float32)
    want = jax_no_cnn.no_cnn_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        jnp.asarray(h), jnp.asarray(c), train_mode=train_mode)
    got = no_cnn.no_cnn_forward(params_from_jax(tree), torch.from_numpy(x),
                                torch.from_numpy(h), torch.from_numpy(c),
                                train_mode=train_mode)
    assert got.shape == (B, 3)
    _close(got, want)


def test_no_cnn_decoder_rereads_x_and_takes_the_encoder_state():
    """The decoder reads x again, seeded with the encoder's FINAL (h, c):
    the caller's state moves the output only through the encoder."""
    rng = np.random.default_rng(2)
    B, W, F, H = 2, 5, 4, 8
    p = no_cnn.init_no_cnn_params(torch.Generator().manual_seed(3),
                                  image_features=F, window=W, hidden=H)
    x = torch.from_numpy(rng.normal(size=(B, W, F)).astype(np.float32))
    h0, c0 = no_cnn.init_state(B, H)
    _, h, c = rnn.lstm_with_state(p["encoder"], x, h0, c0)
    out, _, _ = rnn.lstm_with_state(p["decoder"], x, h, c)
    mlp = out.reshape(B, -1)
    for name in no_cnn._MLP:
        mlp = torch.relu(rnn.linear(p[name], mlp))
    want = torch.softmax(rnn.linear(p["output_layer"], mlp), dim=-1)
    assert torch.equal(no_cnn.no_cnn_forward(p, x, h0, c0), want)


# ------------------------------------------------------------- transformer
def _transformer_tree(seed, F=8, W=7, n_layers=2):
    tree = _numpy(jax_tf.init_transformer_params(
        jax.random.PRNGKey(seed), image_features=F, window=W,
        n_layers=n_layers))
    rng = np.random.default_rng(seed)
    # non-zero attention input biases and LayerNorm affines
    for layer in tree["encoder"]["layers"].values():
        layer["self_attn"]["in_proj_bias"] = rng.normal(
            0, 0.1, layer["self_attn"]["in_proj_bias"].shape).astype(
                np.float32)
        for norm in ("norm1", "norm2"):
            layer[norm]["weight"] = rng.uniform(
                0.5, 1.5, layer[norm]["weight"].shape).astype(np.float32)
            layer[norm]["bias"] = rng.normal(
                0, 0.1, layer[norm]["bias"].shape).astype(np.float32)
    return _random_batchnorm(tree, rng)


@pytest.mark.parametrize("train_mode", [False, True])
def test_transformer_forward_matches_jax(train_mode):
    rng = np.random.default_rng(4)
    B, W, F = 3, 7, 8
    tree = _transformer_tree(5, F, W)
    x = rng.integers(-3, 4, (B, W, F)).astype(np.float32)
    want = jax_tf.transformer_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        train_mode=train_mode)
    got = tf.transformer_forward(params_from_jax(tree), torch.from_numpy(x),
                                 train_mode=train_mode)
    assert got.shape == (B, 3)
    _close(got, want)


def _transformer_with_permute(p, x):
    """transformer_forward with a channel-last permute in place of the
    reference's raw reshape [B,C,T,F] -> [B,T,C*F]."""
    B, T, _ = x.shape
    h = x[:, None]
    out = torch.relu(tf._batchnorm(p["bn1"], torch.nn.functional.conv2d(
        h, p["conv1"]["weight"], padding=1)))
    out = tf._batchnorm(p["bn2"], torch.nn.functional.conv2d(
        out, p["conv2"]["weight"], padding=1))
    out = torch.relu(out + h).permute(0, 2, 1, 3).reshape(B, T, -1)
    for i in range(len(p["encoder"]["layers"])):
        out = tf._encoder_layer(p["encoder"]["layers"][str(i)], out)
    out = out.reshape(B, -1)
    for name in tf._MLP:
        out = torch.relu(rnn.linear(p[name], out))
    return torch.softmax(rnn.linear(p["output_layer"], out), dim=-1)


def test_transformer_raw_reshape_quirk_is_not_a_permute():
    """A permute in place of the raw reshape moves the probabilities past
    ten times the parity tolerance: the parity test above would catch it."""
    rng = np.random.default_rng(6)
    B, W, F = 4, 7, 8
    tree = _transformer_tree(7, F, W)
    x = rng.integers(-3, 4, (B, W, F)).astype(np.float32)
    want = np.asarray(jax_tf.transformer_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    p = params_from_jax(tree)
    permuted = _transformer_with_permute(p, torch.from_numpy(x)).numpy()
    assert np.abs(permuted - want).max() > 10 * TOL
    _close(tf.transformer_forward(p, torch.from_numpy(x)), want)


# ----------------------------------------------------------------- seq2seq
def test_reverse_onehot_matches_jax():
    v = np.array([[0, 1, 0, 3], [2, 0, 0, 0]], np.float32)
    got = s2s.reverse_onehot(torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_s2s.reverse_onehot(jnp.asarray(v))))


def _encoder_tree(H, L):
    tree = _numpy(jax_s2s.init_encoder_params(jax.random.PRNGKey(8),
                                              gru_layers=L, hidden_size=H))
    return _random_batchnorm(tree, np.random.default_rng(8))


def test_encoder_forward_matches_jax():
    rng = np.random.default_rng(9)
    B, T, W, H, L = 3, 12, 20, 8, 2
    tree = _encoder_tree(H, L)
    x = rng.normal(size=(B, 1, T, W)).astype(np.float32)
    hidden = rng.normal(size=(B, 2 * L, H)).astype(np.float32)
    want = jax_s2s.encoder_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.asarray(x), jnp.asarray(hidden), L)
    got = s2s.encoder_forward(params_from_jax(tree), torch.from_numpy(x),
                              torch.from_numpy(hidden), L)
    assert got[0].shape == (B, T, H) and got[1].shape == (B, 2 * L, H)
    for g, w in zip(got, want):
        _close(g, w)


def test_decoder_and_attention_match_jax():
    rng = np.random.default_rng(10)
    B, T, H, L, C, S = 3, 12, 8, 2, 5, 12
    dec = _numpy(jax_s2s.init_decoder_params(jax.random.PRNGKey(11), H, L, C,
                                             S))
    onehot = np.eye(S, dtype=np.float32)[rng.integers(0, S, B)]
    context = rng.normal(size=(B, T, H)).astype(np.float32)
    hidden = rng.normal(size=(B, 2 * L, H)).astype(np.float32)
    want = jax_s2s.decoder_forward(jax.tree_util.tree_map(jnp.asarray, dec),
                                   jnp.asarray(onehot), jnp.asarray(context),
                                   jnp.asarray(hidden), L)
    p = params_from_jax(dec)
    got = s2s.decoder_forward(p, torch.from_numpy(onehot),
                              torch.from_numpy(context),
                              torch.from_numpy(hidden), L)
    assert [tuple(t.shape) for t in got] == [(B, C), (B, 2 * L, H),
                                             (B, 1, T)]
    for g, w in zip(got, want):
        _close(g, w)
    out = rng.normal(size=(B, 4, H)).astype(np.float32)
    want = jax_s2s.attention_forward(
        jax.tree_util.tree_map(jnp.asarray, dec["attention"]),
        jnp.asarray(out), jnp.asarray(context))
    got = s2s.attention_forward(p["attention"], torch.from_numpy(out),
                                torch.from_numpy(context))
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------ init trees
@pytest.mark.parametrize("model", ["transformer", "no_cnn", "encoder",
                                   "decoder"])
def test_init_trees_match_jax(model):
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    own, ref = {
        "transformer": lambda: (tf.init_transformer_params(gen),
                                jax_tf.init_transformer_params(key)),
        "no_cnn": lambda: (no_cnn.init_no_cnn_params(gen),
                           jax_no_cnn.init_no_cnn_params(key)),
        "encoder": lambda: (s2s.init_encoder_params(gen),
                            jax_s2s.init_encoder_params(key)),
        "decoder": lambda: (s2s.init_decoder_params(gen, 128, 3, 5, 1000),
                            jax_s2s.init_decoder_params(key, 128, 3, 5,
                                                        1000)),
    }[model]()
    assert _shapes(own) == _shapes(ref)
    leaves = jax.tree_util.tree_leaves(own)
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for t in leaves)
