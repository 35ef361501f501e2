"""The port's ``DeviceLoader`` on ``device="cpu"``.

Its batches must equal, bit for bit, the port's host path (``NestedLoader``
over ``BatchIterator``) and the JAX ``DeviceLoader``'s: the same (seed,
epoch) permutations over shuffled epochs, the same resume alignment when
``epoch`` is set by hand, zero pad rows with weight 0, the same
``epoch_index_matrix``.  ``PrefetchLoader`` passes its batches through, and
the trainer's dynamic-weight pass gives the same weights through either
loader while consuming one epoch.
"""

import jax
import numpy as np
import pytest
import torch

from fairmultimodal_torch.data import prefetch as t_prefetch
from fairmultimodal_torch.data.device import DeviceLoader
from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
from fairmultimodal_torch.data.prefetch import PrefetchLoader
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
from fairmultimodal_tpu.data.device import DeviceLoader as JDeviceLoader


def _arrays(n=37, seed=0):
    rng = np.random.default_rng(seed)
    model_inputs = {
        "demo_dummy_ids": np.zeros((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, 4, n).astype(np.int32),
        "gender_ids": rng.integers(0, 2, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
        "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, 6)).astype(np.float32),
        "text_embedding": rng.normal(0, 1, (n, 8)).astype(np.float32),
    }
    return model_inputs, rng.integers(0, 2, (n, 3)).astype(np.float32)


def _host(model_inputs, labels, bsz, shuffle, seed):
    flat = dict(model_inputs, labels=labels)
    return NestedLoader(BatchIterator(flat, bsz, shuffle=shuffle, seed=seed), model_inputs)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_batches_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        for key in ("labels", "weight"):
            a, b = _np(w[key]), _np(g[key])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
        assert sorted(w["model_inputs"]) == sorted(g["model_inputs"])
        for k, v in w["model_inputs"].items():
            a, b = _np(v), _np(g["model_inputs"][k])
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("shuffle,bsz", [(False, 8), (True, 16), (True, 37), (False, 64)])
def test_batches_equal_the_host_path_and_jax_over_two_epochs(shuffle, bsz):
    model_inputs, labels = _arrays(seed=1)
    host = _host(model_inputs, labels, bsz, shuffle, 7)
    dev = DeviceLoader(model_inputs, labels, bsz, shuffle=shuffle, seed=7, device="cpu")
    jdev = JDeviceLoader(model_inputs, labels, bsz, shuffle=shuffle, seed=7)
    for _ in range(2):
        got = list(dev)
        _assert_batches_equal(list(host), got)
        _assert_batches_equal([jax.tree_util.tree_map(np.asarray, b) for b in jdev], got)
        assert all(b["labels"].device.type == "cpu" for b in got)
    assert dev.epoch == jdev.epoch == (2 if shuffle else 0)


def test_epoch_index_matrix_matches_jax_and_consumes_an_epoch():
    model_inputs, labels = _arrays(n=45, seed=2)
    dev = DeviceLoader(model_inputs, labels, 16, shuffle=True, seed=3, device="cpu")
    jdev = JDeviceLoader(model_inputs, labels, 16, shuffle=True, seed=3)
    for _ in range(2):
        (i_t, v_t), (i_j, v_j) = dev.epoch_index_matrix(), jdev.epoch_index_matrix()
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_array_equal(v_t, v_j)
        assert i_t.dtype == np.int32 and v_t.dtype == bool and i_t.shape == (3, 16)
    assert dev.epoch == 2
    # The matrix of epoch 2 is the permutation __iter__ draws at epoch 2.
    idx, valid = dev.epoch_index_matrix()
    dev.epoch = 2
    first = next(iter(dev))
    np.testing.assert_array_equal(first["model_inputs"]["age_ids"].numpy(),
                                  model_inputs["age_ids"][idx[0]])
    assert valid.sum() == 45


def test_resume_alignment_by_setting_epoch():
    model_inputs, labels = _arrays(seed=2)
    a = DeviceLoader(model_inputs, labels, 16, shuffle=True, seed=3, device="cpu")
    list(a)
    ref = list(a)                       # epoch 1
    b = DeviceLoader(model_inputs, labels, 16, shuffle=True, seed=3, device="cpu")
    b.epoch = 1
    _assert_batches_equal(ref, list(b))


def test_pad_rows_zeroed_with_weight_zero():
    model_inputs, labels = _arrays(n=10)
    model_inputs["lab_features"] += 5.0           # no real zero in the pad region
    (batch,) = list(DeviceLoader(model_inputs, labels, 16, device="cpu"))
    w = batch["weight"].numpy()
    assert w.dtype == np.float32 and w[:10].all() and not w[10:].any()
    for v in list(batch["model_inputs"].values()) + [batch["labels"]]:
        assert not v[10:].any()
    assert batch["model_inputs"]["lab_features"][:10].all()


def test_add_arrays_and_ragged_input():
    model_inputs, labels = _arrays(n=20)
    dev = DeviceLoader(model_inputs, labels, 8, device="cpu")
    dev.add_arrays({"extra": np.arange(20, dtype=np.float32)[:, None]})
    batches = list(dev)
    assert batches[-1]["model_inputs"]["extra"][:4, 0].tolist() == [16, 17, 18, 19]
    assert not batches[-1]["model_inputs"]["extra"][4:].any()
    with pytest.raises(ValueError, match="length"):
        dev.add_arrays({"bad": np.zeros(3)})
    with pytest.raises(ValueError, match="ragged"):
        DeviceLoader(model_inputs, labels[:5], 8, device="cpu")


def test_prefetch_passes_device_batches_through(monkeypatch):
    model_inputs, labels = _arrays(n=20)
    dev = DeviceLoader(model_inputs, labels, 8, device="cpu")
    want = list(dev)

    def no_copy(*args):
        raise AssertionError("a device-resident batch was copied")

    monkeypatch.setattr(t_prefetch, "to_device", no_copy)
    got = list(PrefetchLoader(dev, torch.device("cpu")))
    _assert_batches_equal(want, got)


def test_dynamic_weights_through_either_loader():
    model_inputs, labels = _arrays(n=50, seed=4)
    model = init_params(FAMEModel(num_ages=4, num_genders=2, num_ethnicities=5,
                                  num_insurances=6, lab_token_count=6, text_embed_size=8,
                                  hidden_size=16, demo_layers=1, demo_heads=2, lab_layers=1,
                                  lab_heads=2, fusion_hidden=8), seed=0)
    trainer = FAMETrainer(model, TrainConfig(batch_size=16), np.ones(3, np.float32),
                          device="cpu")
    host = _host(model_inputs, labels, 16, True, 5)
    dev = DeviceLoader(model_inputs, labels, 16, shuffle=True, seed=5, device="cpu")
    w_host = trainer.update_dynamic_weights(host).copy()
    trainer.dynamic_weights = np.full((3, 3), 0.33)
    w_dev = trainer.update_dynamic_weights(dev)
    np.testing.assert_array_equal(w_host, w_dev)
    assert not np.array_equal(w_dev, np.full((3, 3), 0.33))
    assert dev.epoch == host.it.epoch == 1
