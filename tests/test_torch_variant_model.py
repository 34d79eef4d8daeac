"""The port's variant classifier and checkpoints against the JAX package's,
with the same weights and inputs (f32 on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from pepper_tpu.models import checkpoint as jax_ckpt
from pepper_tpu.models.variant_model import (
    init_variant_params as jax_init_variant_params,
    variant_forward as jax_variant_forward)
from pepper_tpu_torch.models import checkpoint as ckpt
from pepper_tpu_torch.models.variant_model import (init_variant_params,
                                                   variant_forward)


def _jax_tree(seed, features=26, window=33):
    params = jax_init_variant_params(jax.random.PRNGKey(seed),
                                     image_features=features, window=window)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("window,features", [(33, 26), (21, 48)])
def test_variant_forward_matches_jax(window, features):
    tree = _jax_tree(1, features, window)
    x = np.random.default_rng(2).integers(
        -125, 126, (6, window, features)).astype(np.float32)
    want = np.asarray(jax_variant_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        fused_rnn=False))
    got = variant_forward(ckpt.params_from_jax(tree), torch.from_numpy(x))
    assert got.shape == (6, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


class TorchVariantModel(nn.Module):
    """Reference-architecture twin from stock torch layers (a stand-in for
    a reference checkpoint, as in tests/test_models.py)."""

    def __init__(self, F=26, H=256, window=33):
        super().__init__()
        self.encoder = nn.LSTM(F, H, bidirectional=True, batch_first=True)
        self.decoder = nn.LSTM(2 * H, H, bidirectional=True, batch_first=True)
        self.linear_1 = nn.Linear(2 * H * window, 512)
        self.linear_2 = nn.Linear(512, 512)
        self.linear_3 = nn.Linear(512, 512)
        self.linear_4 = nn.Linear(512, 512)
        self.linear_5 = nn.Linear(512, 512)
        self.output_layer_type = nn.Linear(512, 3)


def test_module_prefixed_state_dict_matches_jax():
    torch.manual_seed(0)
    m = TorchVariantModel()
    state = {"module." + k: v for k, v in m.state_dict().items()}
    x = np.random.default_rng(3).standard_normal((4, 33, 26)) \
        .astype(np.float32)
    tree = ckpt.from_torch_state_dict(state)
    got = variant_forward(ckpt.params_from_jax(tree), torch.from_numpy(x))
    jax_tree = jax_ckpt.from_torch_state_dict(state)
    want = np.asarray(jax_variant_forward(
        jax.tree_util.tree_map(jnp.asarray, jax_tree), jnp.asarray(x),
        fused_rnn=False))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the prefix is stripped: same tree as the unprefixed state dict
    plain = ckpt.from_torch_state_dict(m.state_dict())
    assert plain.keys() == tree.keys()


def test_torch_checkpoint_file_loads(tmp_path):
    torch.manual_seed(1)
    m = TorchVariantModel()
    path = str(tmp_path / "model.pkl")
    torch.save({"model_state_dict": m.state_dict(), "hidden_size": 256,
                "epochs": 4}, path)
    tree, meta = ckpt.load_torch_checkpoint(path)
    assert meta == {"hidden_size": 256, "epochs": 4}
    np.testing.assert_array_equal(
        tree["encoder"]["weight_hh_l0"],
        m.encoder.weight_hh_l0.detach().numpy())


def test_checkpoints_cross_load_between_packages(tmp_path):
    tree = _jax_tree(5)
    jax_path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(jax_path, tree, {"epochs": 2})
    loaded, meta = ckpt.load_checkpoint(jax_path)
    assert meta == {"epochs": 2}
    params = ckpt.params_from_jax(loaded)
    for group, leaves in tree.items():
        for name, value in leaves.items():
            np.testing.assert_array_equal(params[group][name].numpy(), value)

    torch_path = str(tmp_path / "torch.npz")
    ckpt.save_checkpoint(torch_path, params, {"epochs": 3})
    back, meta = jax_ckpt.load_checkpoint(torch_path)
    assert meta == {"epochs": 3}
    for group, leaves in tree.items():
        for name, value in leaves.items():
            np.testing.assert_array_equal(back[group][name], value)


def test_params_from_jax_dtype_and_layout():
    tree = _jax_tree(6)
    params = ckpt.params_from_jax(tree, "cpu", torch.bfloat16)
    assert params.keys() == tree.keys()
    for group, leaves in tree.items():
        for name, value in leaves.items():
            t = params[group][name]
            assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
            assert tuple(t.shape) == value.shape
            np.testing.assert_array_equal(
                t.float().numpy(),
                torch.from_numpy(value).bfloat16().float().numpy())


def test_init_variant_params_matches_jax_shapes():
    ours = init_variant_params(torch.Generator().manual_seed(0))
    ref = _jax_tree(0)
    assert ours.keys() == ref.keys()
    for group in ref:
        assert {k: tuple(v.shape) for k, v in ours[group].items()} == \
            {k: v.shape for k, v in ref[group].items()}
