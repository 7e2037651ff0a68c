"""Shared helpers of the tests/test_torch_*.py files (not a test module).

It imports no jax, so the GPU tests can use it on a machine without jax:
value converters between the reference's limbs and the port's words, circuit
factories that build one class per package (each package has its own
frontend module instance, and ``api.py`` checks inputs with ``isinstance``),
and the fixtures the tests share.  A test module activates the fixtures by
importing them."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from algoplonk_tpu_torch.fields.params import LIMB_BITS
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.fields.words import WordField, mont_words_to_ints, word_field


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' tensors are tiny, so torch's intra-op thread pool is pure
    overhead (and the test workers already share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where torch finds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def field_values(p: int, rng: random.Random, n: int = 13) -> list[int]:
    """Edge values 0, 1, p - 1, p - 2, 2, then randoms."""
    return [0, 1, p - 1, p - 2, 2] + [rng.randrange(p) for _ in range(n - 5)]


def canon_edge_values(p: int, W: int, rng: random.Random, n: int) -> list[int]:
    """n W-word values for K4 (canon): 0, 1, p - 1, p, and k p - 1, k p,
    k p + 1 for every k up to the largest quotient floor((2^(32 W) - 1) /
    p), 2^(32 W) - 1 and 2^(32 W - 1), then seeded random words."""
    top = (1 << (32 * W)) - 1
    edges = [0, 1, p - 1, p]
    edges += [v for k in range(1, top // p + 1) for v in (k * p - 1, k * p, k * p + 1)]
    edges += [top, 1 << (32 * W - 1)]
    return edges + [rng.randrange(top + 1) for _ in range(n - len(edges))]


def sample_points(rng: random.Random, curve, n: int) -> list:
    F = hfp.GF(curve.fp.modulus)
    return [hfp.ec_mul(F, curve.g1, rng.randrange(1, 1 << 64)) for _ in range(n)]


def jax_ints(arr, fp) -> list[int]:
    """Reference Montgomery limbs [..., L] -> canonical ints.  Limbs may be
    relaxed (above 2^12, as the Pallas kernels leave them), so the value is
    summed rather than OR-ed before leaving Montgomery form."""
    a = np.asarray(arr).astype(np.int64)
    R_inv = pow(fp.R, -1, fp.modulus)
    out = []
    for row in a.reshape(-1, a.shape[-1]):
        v = 0
        for limb in reversed(row.tolist()):
            v = (v << LIMB_BITS) + limb
        out.append(v * R_inv % fp.modulus)
    return out


def mont_words_to_jax_limbs(arr, wf: WordField) -> np.ndarray:
    """Port Montgomery words [..., W] -> reference Montgomery limbs [..., L]."""
    a = np.asarray(arr)
    fp = wf.fp
    mask = (1 << LIMB_BITS) - 1
    limbs = [
        (fp.to_mont(v) >> (LIMB_BITS * k)) & mask
        for v in mont_words_to_ints(a.reshape(-1, a.shape[-1]), wf)
        for k in range(fp.nlimbs)
    ]
    return np.asarray(limbs, np.int32).reshape(a.shape[:-1] + (fp.nlimbs,))


def port_ints(t: torch.Tensor, fp) -> list[int]:
    """Port Montgomery words [..., W] -> canonical ints."""
    a = t.detach().cpu().numpy()
    return mont_words_to_ints(a.reshape(-1, a.shape[-1]), word_field(fp))


def affine_of(proj_ints: list[int], p: int) -> list:
    """Flat (X, Y, Z) ints -> affine tuples (None for Z = 0)."""
    out = []
    for i in range(0, len(proj_ints), 3):
        X, Y, Z = proj_ints[i : i + 3]
        if Z == 0:
            out.append(None)
        else:
            zi = pow(Z, -1, p)
            out.append((X * zi % p, Y * zi % p))
    return out


def pythagorean(pkg):
    class Pythagorean(pkg.Circuit):
        a = pkg.PublicInput()
        b = pkg.PublicInput()
        c = pkg.SecretInput()

        def define(self, api):
            a2 = api.mul(self.a, self.a)
            b2 = api.mul(self.b, self.b)
            c2 = api.mul(self.c, self.c)
            api.assert_is_equal(api.add(a2, b2), c2)

    return Pythagorean


def one_commit(pkg):
    """A BSB22 circuit: one frontend commitment."""

    class OneCommit(pkg.Circuit):
        x = pkg.PublicInput()
        y = pkg.SecretInput()

        def define(self, api):
            t = api.mul(self.y, self.y)
            v = api.commit(t)
            api.assert_is_different(v, 0)
            api.assert_is_equal(t, self.x)

    return OneCommit
