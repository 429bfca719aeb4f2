"""The port's on-device RandomResizedCrop + flip (vision_toolbox_tpu_torch/
ops/device_rrc.py) and its device-resident train step (train/step.py
``make_device_data_train_step``) vs the JAX package's.

- ``_axis_weights`` (rel/abs 1e-6) and ``crop_resize_flip`` (abs 1e-5, f32,
  [0, 1] images: two products summed in another order) on the JAX
  package's boxes and flips, drawn by its ``sample_rrc_boxes``;
- the port's own ``sample_rrc_boxes`` (from a ``torch.Generator``): boxes
  inside the frame with areas in the scale range, the full frame at scale
  and ratio 1, the centre-crop fallback equal to the JAX package's;
- two device-resident steps at 16 px (batch 8 from a (32, 24, 24, 3) uint8
  store, CutMix⊕MixUp, label smoothing, SGD) with the JAX step's draws
  passed in: loss rel ≤ 1e-5 at each step, all parameters and BatchNorm
  statistics together rel L2 ≤ 1e-5 (measured 3e-7 and 1e-7). The model is
  test_torch_train_step.py's narrow CSP Darknet: full-width darknet19 at
  16 px normalizes its last stages over a few values per channel and
  amplifies f32 summation order (measured there: 4e-6 after the first step,
  2.4e-4 after the second, in loss and in parameters alike);
- a degenerate crop (full frame, no flip) makes the device-resident step
  the host-fed step on ``store[idx]``, bit for bit, on darknet19 (the JAX
  package holds the same, tests/test_device_rrc.py:125).
"""

import numpy as np
import pytest
import torch
from torch_draws import step_draws

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.device_rrc as jrrc
from vision_toolbox_tpu import create_backbone as jax_backbone
from vision_toolbox_tpu.models.darknet import Darknet as JaxDarknet
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu.train import warmup_cosine_schedule as jax_schedule
from vision_toolbox_tpu.train.step import make_device_data_train_step as jax_device_step
from vision_toolbox_tpu_torch import create_backbone
from vision_toolbox_tpu_torch.models.darknet import Darknet
from vision_toolbox_tpu_torch.ops import device_rrc
from vision_toolbox_tpu_torch.train import (
    DeviceStepDraws,
    ImageClassifier,
    TrainState,
    make_device_data_train_step,
    make_train_step,
    sgd_with_param_groups,
    warmup_cosine_schedule,
)
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
SCHEDULE = dict(base_lr=0.1, total_epochs=10, steps_per_epoch=10)
CLASSES, B, STORE, CROP = 10, 8, 24, 16
NARROW = dict(stem_channels=8, stage_configs=((1, 16), (1, 32)), csp=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_boxes(key, batch, h, w, hflip_p=0.5, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """The boxes and flips of JAX's ``random_resized_crop_flip(key, ...)``."""
    k_box, k_flip = jax.random.split(key)
    i, j, bh, bw = jrrc.sample_rrc_boxes(k_box, batch, h, w, scale, ratio)
    flip = jax.random.uniform(k_flip, (batch,)) < hflip_p if hflip_p > 0 else None
    return i, j, bh, bw, flip


def test_axis_weights_match_jax():
    i, j, h, w, flip = _jax_boxes(jax.random.PRNGKey(0), 6, 40, 40)
    for antialias in (True, False):
        for out in (16, 56):
            want = jrrc._axis_weights(j, w, 40, out, antialias, flipped=flip)
            got = device_rrc._axis_weights(_t(j), _t(w), 40, out, antialias, flipped=_t(flip))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,out", [((4, 40, 40, 3), 24), ((3, 24, 30, 3), 32)])
def test_crop_resize_flip_matches_jax(shape, out):
    images = np.random.default_rng(1).random(shape, np.float32)
    boxes = _jax_boxes(jax.random.PRNGKey(3), shape[0], shape[1], shape[2])
    for antialias in (True, False):
        want = jrrc.crop_resize_flip(jnp.asarray(images), *boxes, out, antialias)
        got = device_rrc.crop_resize_flip(torch.from_numpy(images), *map(_t, boxes), out, antialias)
        assert got.shape == (shape[0], out, out, 3) and got.dtype == torch.float32
        assert got.is_contiguous()  # the warp kernel after it reads NHWC
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_sample_rrc_boxes_bounds():
    g = torch.Generator().manual_seed(0)
    i, j, h, w = device_rrc.sample_rrc_boxes(g, 512, 40, 30)
    assert all(t.dtype == torch.float32 and t.shape == (512,) for t in (i, j, h, w))
    assert (i >= 0).all() and (j >= 0).all() and (i + h <= 40 + 1e-4).all() and (j + w <= 30 + 1e-4).all()
    area = h * w / (40 * 30)
    assert (area <= 1 + 1e-4).all() and (area >= 0.08 * 0.999).all()
    ratio = w / h
    assert (ratio >= 3 / 4 * 0.999).all() and (ratio <= 4 / 3 * 1.001).all()
    assert len(set(i.tolist())) > 400  # the draws differ per image


@pytest.mark.parametrize("src", [(32, 32), (20, 50), (50, 20)])
def test_sample_rrc_boxes_full_frame_and_fallback(src):
    H, W = src
    g = torch.Generator().manual_seed(1)
    if H == W:  # every attempt is the full frame
        boxes = device_rrc.sample_rrc_boxes(g, 8, H, W, scale=(1.0, 1.0), ratio=(1.0, 1.0))
        for t, v in zip(boxes, (0.0, 0.0, H, W)):
            np.testing.assert_allclose(t.numpy(), v, rtol=1e-5, atol=1e-3)
    # an area above the frame's: no attempt is valid, the centre crop at the
    # nearest in-range aspect remains
    got = device_rrc.sample_rrc_boxes(g, 4, H, W, scale=(1.5, 2.0))
    want = jrrc.sample_rrc_boxes(jax.random.PRNGKey(0), 4, H, W, scale=(1.5, 2.0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_random_resized_crop_flip_draws_from_the_generator():
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    run = lambda seed: device_rrc.random_resized_crop_flip(torch.Generator().manual_seed(seed), x, 16)
    a, b = run(0), run(1)
    assert a.shape == (4, 16, 16, 3)
    assert torch.equal(a, run(0)) and not torch.allclose(a, b)


def _variables(jm):
    init = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                   jnp.zeros((1, CROP, CROP, 3)), train=False))
    return jax.tree.map(np.asarray, init())


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (32, STORE, STORE, 3), np.uint8),
            rng.integers(0, CLASSES, 32).astype(np.int32))


def _port_state(backbone, variables):
    pm = ImageClassifier(backbone, CLASSES)
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]),
                       strict=True)
    opt = sgd_with_param_groups(pm, warmup_cosine_schedule(**SCHEDULE), momentum=0.9,
                                weight_decay=1e-4)
    return TrainState(pm, opt)


def test_device_step_matches_jax(store):
    store, labels = store
    jm = JaxClassifier(backbone=JaxDarknet(**NARROW), num_classes=CLASSES)
    variables = _variables(jm)
    tx = jax_sgd(variables["params"], jax_schedule(**SCHEDULE), momentum=0.9, weight_decay=1e-4)
    jstate = JaxState.create(jm.apply, variables, tx)
    jstep = jax.jit(jax_device_step(CLASSES, CROP, **RECIPE))
    state = _port_state(Darknet(**NARROW, device="cpu"), variables)
    step = make_device_data_train_step(CLASSES, CROP, **RECIPE)
    rng = jax.random.PRNGKey(7)
    idxs = ([5, 1, 30, 7, 22, 9, 0, 14], [3, 3, 31, 2, 17, 8, 11, 26])
    for n, idx in enumerate(idxs):
        rng_rrc = jax.random.fold_in(jax.random.fold_in(rng, 0x5EED), n)
        boxes = _jax_boxes(rng_rrc, B, STORE, STORE)
        draws = DeviceStepDraws(device_rrc.RRCDraws(*map(_t, boxes)),
                                step_draws(rng, n, (B, CROP, CROP, 3), **{k: RECIPE[k] for k in
                                                                          ("mixup_alpha",
                                                                           "cutmix_alpha")}))
        jstate, jm_out = jstep(jstate, jnp.asarray(store), jnp.asarray(labels),
                               jnp.asarray(idx, jnp.int32), rng)
        got = step(state, torch.from_numpy(store), torch.from_numpy(labels),
                   torch.tensor(idx, dtype=torch.int32), draws=draws)
        want = float(jm_out["loss"])
        assert abs(float(got["loss"]) - want) <= 1e-5 * abs(want), (n, float(got["loss"]), want)
    assert state.step == 2
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params),
                              jax.tree.map(np.asarray, jstate.batch_stats))
    got = state.model.state_dict()
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    den = sum(float((w.double() ** 2).sum()) for w in want.values())
    assert (num / den) ** 0.5 <= 1e-5


def test_degenerate_crop_is_the_host_fed_step(store):
    store, labels = store
    variables = _variables(JaxClassifier(backbone=jax_backbone("darknet19"), num_classes=CLASSES))
    build = lambda: _port_state(create_backbone("darknet19", device="cpu"), variables)
    idx = torch.tensor([5, 1, 30, 7, 22, 9, 0, 14])
    dev_step = make_device_data_train_step(CLASSES, STORE, rrc_scale=(1.0, 1.0),
                                           rrc_ratio=(1.0, 1.0), hflip_p=0.0, **RECIPE)
    host_step = make_train_step(CLASSES, **RECIPE)
    g = torch.Generator().manual_seed(2)
    draws = dev_step.sample_draws(g, B, STORE, STORE)
    assert draws.rrc.flip is None
    s_dev, s_host = build(), build()
    store_t, labels_t = torch.from_numpy(store), torch.from_numpy(labels)
    loss_dev = dev_step(s_dev, store_t, labels_t, idx, draws=draws)["loss"]
    loss_host = host_step(s_host, store_t[idx], labels_t[idx], draws=draws.step)["loss"]
    assert torch.equal(loss_dev, loss_host)
    for (name, a), b in zip(s_dev.model.state_dict().items(), s_host.model.state_dict().values()):
        assert torch.equal(a, b), name
