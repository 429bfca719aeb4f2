"""Every random draw in the port takes an explicit ``torch.Generator``:
no source file calls a sampler without one (or a global-RNG sampler at
all), and the training-mode draws of the ViT path (stochastic depth,
dropout, attention dropout) follow the generator they are given and
ignore ``torch.manual_seed``."""

import ast
import pathlib

import pytest
import torch

from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.nn.layers import StochasticDepth
from vision_toolbox_tpu_torch.ops.attention import dot_product_attention

PORT = pathlib.Path(__file__).resolve().parent.parent / "vision_toolbox_tpu_torch"

# samplers that take a generator= argument
_NEEDS_GENERATOR = {"rand", "randn", "randint", "randperm", "bernoulli", "multinomial", "normal",
                    "normal_", "uniform_", "random_", "exponential_", "bernoulli_",
                    "geometric_", "log_normal_", "cauchy_", "poisson"}
# samplers that cannot take one, and the global-RNG dropout modules
_BANNED = {"rand_like", "randn_like", "randint_like", "Dropout", "dropout1d", "dropout2d",
           "alpha_dropout", "feature_alpha_dropout", "_standard_gamma", "_sample_dirichlet"}
# calls on these modules that draw from or reseed a global RNG
_BANNED_ON = {"F": {"dropout"}, "torch": {"manual_seed", "seed"}}


def _name(func: ast.expr) -> str:
    return func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")


def test_no_sampler_without_generator():
    bad = []
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            name, where = _name(node.func), f"{path.relative_to(PORT.parent)}:{node.lineno}"
            owner = node.func.value if isinstance(node.func, ast.Attribute) else None
            if isinstance(owner, ast.Attribute) and owner.attr == "random" \
                    and getattr(owner.value, "id", "") in ("np", "numpy"):
                if name != "default_rng" or not node.args:  # numpy's global RNG
                    bad.append(f"{where} np.random.{name}")
                continue
            if name in _BANNED or name in _BANNED_ON.get(getattr(owner, "id", ""), ()):
                bad.append(f"{where} {name}")
            elif (name in _NEEDS_GENERATOR and owner is not None  # torch.X(...) or t.X_(...)
                  and not any(k.arg == "generator" for k in node.keywords)):
                bad.append(f"{where} {name} without generator=")
    assert not bad, bad


def test_stochastic_depth_follows_its_generator():
    sd = StochasticDepth(0.5)
    draws = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        draws.append(sd.sample_scale(64, True, torch.Generator().manual_seed(3)))
    assert torch.equal(draws[0], draws[1])
    other = sd.sample_scale(64, True, torch.Generator().manual_seed(4))
    assert not torch.equal(draws[0], other)
    assert set(draws[0].flatten().tolist()) == {0.0, 2.0}
    assert sd.sample_scale(64, False) is None
    with pytest.raises(ValueError, match="Generator"):
        sd.sample_scale(64, True)


def test_attention_dropout_follows_its_generator():
    q = torch.randn(2, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    outs = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        outs.append(dot_product_attention(q, q, q, dropout_rate=0.3,
                                          generator=torch.Generator().manual_seed(9)))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], dot_product_attention(q, q, q))
    with pytest.raises(ValueError, match="Generator"):
        dot_product_attention(q, q, q, dropout_rate=0.3)


@pytest.mark.parametrize("force_unfused", [False, True])
def test_vit_training_draws_follow_the_generator(force_unfused):
    """Stochastic depth on the fused and unfused paths, MLP and attention
    dropout on the unfused path."""
    kw = dict(d_model=64, depth=2, n_heads=2, patch_size=8, img_size=16, stochastic_depth=0.5,
              dropout=0.2 if force_unfused else 0.0)
    m = ViT(**kw)
    x = torch.rand(8, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        with torch.no_grad():
            outs.append(m(x, train=True, force_unfused=force_unfused,
                          generator=torch.Generator().manual_seed(2)))
    assert torch.equal(outs[0], outs[1])
    with torch.no_grad():
        assert not torch.equal(outs[0], m(x, train=False, force_unfused=force_unfused))
        with pytest.raises(ValueError, match="Generator"):
            m(x, train=True, force_unfused=force_unfused)
