"""The JAX package's random draws, recomputed from its keys, in the port's
draw types — so a test can run one JAX function and its port on the same
draws.

Each helper repeats the key splits and samplers of the JAX function it
names, line for line:
- ``ta_draws``: ``ops/trivial_augment.py`` ``trivial_augment_wide``;
- ``erase_draws``: ``ops/augment.py`` ``random_erasing``;
- ``mix_draws``: ``ops/augment.py`` ``cutmix_mixup`` / ``cutmix`` / ``mixup``;
- ``step_draws``: ``train/step.py`` ``make_train_step`` (fold_in of the step
  count, then the four-way split).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vision_toolbox_tpu_torch.ops.augment import EraseDraws, MixDraws
from vision_toolbox_tpu_torch.ops.trivial_augment import TADraws
from vision_toolbox_tpu_torch.train.step import StepDraws


def _t(a):
    return torch.from_numpy(np.array(a))


def ta_draws(key, batch: int) -> TADraws:
    rng_op, rng_mag, rng_sign = jax.random.split(key, 3)
    op = jax.random.randint(rng_op, (batch,), 0, 14)
    mag_idx = jax.random.randint(rng_mag, (batch,), 0, 31)
    sign = jnp.where(jax.random.bernoulli(rng_sign, 0.5, (batch,)), 1.0, -1.0)
    return TADraws(_t(op), _t(mag_idx), _t(sign))


def erase_draws(key, shape, p=0.1, scale=(0.02, 0.33), ratio=(0.3, 3.3)) -> EraseDraws:
    N, H, W, C = shape
    rngs = jax.random.split(key, 6)
    apply = jax.random.bernoulli(rngs[0], p, (N, 1, 1, 1))
    area = jax.random.uniform(rngs[1], (N,), minval=scale[0], maxval=scale[1]) * (H * W)
    log_ratio = jax.random.uniform(rngs[2], (N,), minval=jnp.log(ratio[0]),
                                   maxval=jnp.log(ratio[1]))
    top_u = jax.random.uniform(rngs[3], (N,))
    left_u = jax.random.uniform(rngs[4], (N,))
    noise = jax.random.normal(rngs[5], shape, jnp.float32)
    return EraseDraws(_t(apply).reshape(N), _t(area), _t(log_ratio), _t(top_u), _t(left_u),
                      _t(noise))


def mix_draws(key, height, width, cutmix_alpha=1.0, mixup_alpha=0.2) -> MixDraws:
    rng_coin, rng_op = jax.random.split(key)
    if cutmix_alpha <= 0:
        use_cutmix = False
    elif mixup_alpha <= 0:
        use_cutmix = True
    else:
        use_cutmix = bool(jax.random.bernoulli(rng_coin, 0.5))
    if not use_cutmix:
        return MixDraws(False, float(jax.random.beta(rng_op, mixup_alpha, mixup_alpha)))
    rng_lam, rng_x, rng_y = jax.random.split(rng_op, 3)
    lam = float(jax.random.beta(rng_lam, cutmix_alpha, cutmix_alpha))
    return MixDraws(True, lam, int(jax.random.randint(rng_x, (), 0, width)),
                    int(jax.random.randint(rng_y, (), 0, height)))


def step_draws(rng, step: int, shape, *, trivial_augment=False, random_erasing_p=0.0,
               mixup_alpha=0.2, cutmix_alpha=1.0) -> StepDraws:
    rng = jax.random.fold_in(rng, jnp.asarray(step, jnp.int32))
    rng_ta, rng_re, rng_mix, _ = jax.random.split(rng, 4)
    B, H, W, _ = shape
    mix = mixup_alpha > 0 or cutmix_alpha > 0
    return StepDraws(
        ta=ta_draws(rng_ta, B) if trivial_augment else None,
        erase=erase_draws(rng_re, shape, random_erasing_p) if random_erasing_p > 0 else None,
        mix=mix_draws(rng_mix, H, W, cutmix_alpha, mixup_alpha) if mix else None,
    )
