"""The port's npz writer and the inverse of ``interop.state_dict_from_flax``.

- JAX params -> the port's model (``load_flax_params``) -> the port's
  ``save_params_npz``: the keys (in order), shapes, dtypes, values and
  metadata bytes equal JAX ``save_params_npz``'s file, and JAX
  ``load_params_npz(path, like)`` accepts it; the same for a BERT encoder
  tree;
- each package's predictor reads the other's checkpoint: the same
  probabilities to 1e-5 (fp32), from JAX-initialised weights and from the
  port's own seeded init (whose values JAX never saw).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.interop import flax_params, load_flax_params
from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import fusion as t_fusion
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.pipelines import inference as t_inf
from fairmultimodal_torch.utils import checkpoint as t_ckpt
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models import fusion as j_fusion
from fairmultimodal_tpu.pipelines import inference as j_inf
from fairmultimodal_tpu.utils import checkpoint as j_ckpt

GEO = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6, lab_token_count=10,
           text_embed_size=12, hidden_size=32, demo_layers=1, demo_heads=2, lab_layers=2,
           lab_heads=2, fusion_hidden=16)
META = {"model": GEO, "thresholds": {"mortality": 0.4, "los": 0.5, "mechanical_ventilation": 0.6},
        "dynamic_weights": [[0.2, 0.5, 0.3], [0.3, 0.3, 0.4], [0.4, 0.4, 0.2]]}
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=32)


def _arrays(n=37, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "demo_dummy_ids": np.zeros((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, 4, n).astype(np.int32),
        "gender_ids": rng.integers(0, 2, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
        "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, GEO["lab_token_count"])).astype(np.float32),
        "text_embedding": rng.normal(0, 1, (n, GEO["text_embed_size"])).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_model():
    model = j_fusion.FAMEModel(**GEO)
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 {k: jnp.asarray(v[:4]) for k, v in _arrays().items()})
    return model, jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))


def _bert_params():
    cfg = j_bert.BertConfig(**BERT)
    params = jax.jit(j_bert.BertEncoderModel(cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    return (t_bert.BertEncoderModel(t_bert.BertConfig(**BERT)),
            jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"])))


@pytest.mark.parametrize("which", ["fame", "bert"])
def test_port_npz_equals_the_jax_npz(which, jax_model, tmp_path):
    if which == "fame":
        t_model, params = t_fusion.FAMEModel(**GEO), jax_model[1]
    else:
        t_model, params = _bert_params()
    load_flax_params(t_model, params)
    j_path, t_path = tmp_path / "jax.npz", tmp_path / "port.npz"
    j_ckpt.save_params_npz(str(j_path), params, metadata=META)
    t_ckpt.save_params_npz(str(t_path), flax_params(t_model), metadata=META)
    with np.load(j_path) as want, np.load(t_path) as got:
        assert got.files == want.files and "__metadata_json__" in got.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = j_ckpt.load_params_npz(str(t_path), params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert t_ckpt.load_metadata_npz(str(t_path)) == j_ckpt.load_metadata_npz(str(j_path))


def test_flax_params_of_a_state_dict_and_by_module_type():
    """A saved state (not the live parameters) is what gets written, and a
    square Dense kernel is transposed while a square Embed table is not."""
    geo = dict(GEO, hidden_size=4, num_ages=4, demo_heads=2, lab_heads=2, fusion_hidden=4)
    model = init_params(t_fusion.FAMEModel(**geo), seed=1)
    state = {k: v.clone() + 1.0 for k, v in model.state_dict().items()}
    tree = flax_params(model, state)
    age = tree["behrt_demo"]["age_embedding"]["embedding"]
    assert age.shape == (4, 4)
    np.testing.assert_array_equal(age, state["behrt_demo.age_embedding.weight"].numpy())
    q = state["behrt_lab.layer_0.query.weight"].numpy()
    assert q.shape == (4, 4)
    np.testing.assert_array_equal(tree["behrt_lab"]["layer_0"]["query"]["kernel"], q.T)
    norm = tree["behrt_lab"]["layer_0"]["norm1"]
    assert set(norm) == {"scale", "bias"}
    np.testing.assert_array_equal(norm["scale"], state["behrt_lab.layer_0.norm1.weight"].numpy())
    np.testing.assert_array_equal(tree["behrt_lab"]["pos_embedding"],
                                  state["behrt_lab.pos_embedding"].numpy())
    restored = load_flax_params(t_fusion.FAMEModel(**geo), tree)
    for k, v in restored.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("init", ["jax", "port"])
def test_each_predictor_reads_the_other_packages_npz(init, jax_model, tmp_path):
    j_model, params = jax_model
    arrays = _arrays(n=41, seed=5)
    dw = np.asarray(META["dynamic_weights"], np.float32)
    t_model = t_fusion.FAMEModel(**GEO)
    if init == "jax":
        load_flax_params(t_model, params)
    else:
        init_params(t_model, seed=7)
        params = jax.tree_util.tree_map(np.asarray, flax_params(t_model))
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_ckpt.save_params_npz(j_path, params, metadata=META)
    t_ckpt.save_params_npz(t_path, flax_params(t_model), metadata=META)

    # The JAX predictor on the port's file.
    j_read = j_ckpt.load_params_npz(t_path, params)
    want = j_inf.FAMEPredictor(j_model, j_read, META["thresholds"], batch_size=16,
                               dynamic_weights=dw).predict_arrays(arrays)
    # The port's predictor on the JAX file.
    t_read = load_flax_params(t_fusion.FAMEModel(**t_ckpt.load_metadata_npz(j_path)["model"]),
                              t_ckpt.load_params_npz(j_path))
    got = t_inf.FAMEPredictor(t_read, META["thresholds"], batch_size=16, dynamic_weights=dw,
                              device="cpu").predict_arrays(arrays)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["preds"], want["preds"])
