"""Differentiable rendering: parameter traversal, optimizers, render_torch.

Port of ``mitsuba_nlvrl_tpu/autodiff.py`` on torch autograd:

  * ``traverse(scene)``  -> ``ParameterMap`` over the differentiable
                            leaves of the scene
  * ``render(...)``      -> an image through which autograd reaches the
                            parameters; the integrators run their ``diff``
                            bounce loops, each bounce and walk trip
                            checkpointed (``core/remat.py``)
  * ``SGD`` / ``Adam``   -> ``torch.optim`` optimizers with the reference's
                            ``ParameterMap`` convention; they take the
                            steps of ``optax.sgd`` / ``optax.adam``
                            (Adam in optax's arithmetic, ``_OptaxAdam``)
  * ``render_torch(...)`` -> a callable from parameter tensors to the
                            image; the render is torch already, so no
                            bridge is needed

A training step::

    pm = traverse(scene).keep(['bsdfs.params'])
    opt = Adam(pm, lr=0.05)
    img = render(scene, meta, params=opt.params, pmap=pm, spp=1, seed=3)
    loss = ((img - target) ** 2).mean()
    opt.zero_grad()
    loss.backward()
    opt.step()
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .core import rng
from . import film as film_mod
from .integrators.common import film_sample_positions
from .medium import with_sigma_grid
from .parallel.render_dist import render_wavefront
from .scene.types import SceneData

# the differentiable leaves of SceneData, by path
_DIFF_LEAVES = {
    'bsdfs.params': lambda s: s.bsdfs.params,
    'emitters.params': lambda s: s.emitters.params,
    'emitters.env_map': lambda s: s.emitters.env_map,
    'media.params': lambda s: s.media.params,
    'media.grid_sigma_t': lambda s: s.media.grid_sigma_t,
    'media.grid_albedo': lambda s: s.media.grid_albedo,
    'media.nl_ior': lambda s: s.media.nl_ior,
}

# the reference's fold_in constant of the derivative pass's stream
_DERIV_STREAM = 0xDE21


def _set_leaf(scene: SceneData, key: str, value) -> SceneData:
    """``scene`` with the leaf ``key`` replaced. The density grid has
    derived copies (supervoxel bounds, the corner-packed rows): a value
    without autograd history (an optimizer step) refreshes them; a value
    that requires grad drops the packed copy, which the diff render does
    not read, and keeps ``grid_sup`` as a fixed bound (valid while the
    densities stay below it), as the reference does for a traced value.
    Every other leaf is a plain replace: an ``env_map`` keeps the sampling
    tables it was built with, as in the reference."""
    group, leaf = key.split('.', 1)
    sub = getattr(scene, group)
    if key == 'media.grid_sigma_t':
        if value.requires_grad:
            sub = sub._replace(grid_sigma_t=value, grid_sigma_p8=None)
        else:
            sub = with_sigma_grid(sub, value)
        return scene._replace(media=sub)
    return scene._replace(**{group: sub._replace(**{leaf: value})})


class ParameterMap:
    """Dict-like view of the differentiable scene parameters (the
    reference's ``ParameterMap``)."""

    def __init__(self, scene: SceneData, keys=None):
        self.scene = scene
        self._keys = list(keys or _DIFF_LEAVES.keys())

    def keys(self):
        return list(self._keys)

    def __contains__(self, k):
        return k in self._keys

    def __getitem__(self, k):
        return _DIFF_LEAVES[k](self.scene)

    def __setitem__(self, k, v):
        old = _DIFF_LEAVES[k](self.scene)
        self.scene = _set_leaf(self.scene, k, torch.as_tensor(
            v, dtype=old.dtype, device=old.device))

    def keep(self, keys):
        """Restrict to a subset (``ParameterMap.keep``)."""
        self._keys = [k for k in self._keys if k in keys]
        return self

    def to_dict(self) -> Dict[str, torch.Tensor]:
        return {k: _DIFF_LEAVES[k](self.scene) for k in self._keys}

    def updated_scene(self, values: Dict[str, torch.Tensor]) -> SceneData:
        sc = self.scene
        for k, v in values.items():
            sc = _set_leaf(sc, k, v)
        return sc


def traverse(scene: SceneData) -> ParameterMap:
    return ParameterMap(scene)


def _render_helper(scene, meta, spp, seed, integrator, diff=True):
    """``spp`` passes of ``render_wavefront`` with the reference's keys
    (pass p: ``fold_in(key, p)``, its film positions from
    ``fold_in(., 0)``), each splatted with the film's filter."""
    key = rng.PRNGKey(seed) if isinstance(seed, int) else seed
    dev = scene.device
    acc = None
    for p in range(spp):
        kp = rng.fold_in(key, p)
        pos, _ = film_sample_positions(meta, rng.fold_in(kp, 0), p, dev)
        L = render_wavefront(scene, meta, pos, kp, integrator, diff=diff)
        img = film_mod.splat(meta.film, pos, L,
                             torch.ones((pos.shape[0],), device=dev),
                             film_mod.new_image(meta.film, device=dev))
        acc = img if acc is None else acc + img
    return film_mod.develop(acc)


def render(scene, meta, params: Optional[Dict] = None,
           pmap: Optional[ParameterMap] = None,
           spp=1, seed: int = 0, integrator: Optional[str] = None,
           unbiased: bool = False):
    """Differentiable render: autograd flows to ``params`` (a dict from a
    ``ParameterMap``, whose tensors require grad) or to any leaf of the
    scene that requires grad. (H, W, 3) on the scene's device.

    ``unbiased=True``: the plain estimator uses one set of samples for the
    image's value and its derivative, so an objective differentiated
    jointly (d mean(I^2)) picks up their correlation. Unbiased mode renders
    twice with independent streams, the value without gradients and the
    derivative on ``fold_in(PRNGKey(seed), 0xDE21)``, and returns
    ``primal + deriv - deriv.detach()``: the value of the first, the
    gradient of the second. ``spp`` may then be a ``(spp_primal,
    spp_deriv)`` tuple."""
    if params is not None:
        pm = pmap or ParameterMap(scene)
        scene = pm.updated_scene(params)
    if not unbiased:
        if isinstance(spp, tuple):
            raise ValueError("tuple spp requires unbiased=True")
        return _render_helper(scene, meta, spp, seed, integrator)
    spp_p, spp_d = spp if isinstance(spp, tuple) else (spp, spp)
    with torch.no_grad():
        primal = _render_helper(scene, meta, spp_p, seed, integrator)
    dseed = rng.fold_in(rng.PRNGKey(seed), _DERIV_STREAM)
    deriv = _render_helper(scene, meta, spp_d, dseed, integrator)
    return primal + deriv - deriv.detach()


class _Optimizer:
    """``ParameterMap``-style optimizer (the reference's ``Optimizer``):
    holds the parameters as leaf tensors, steps them with a
    ``torch.optim`` optimizer and writes them back into the scene.
    ``params`` may be assigned a dict: the values are copied into the
    held tensors, so the optimizer's state carries over, as the
    reference's optax state does."""

    def __init__(self, pmap: ParameterMap, make):
        self.pmap = pmap
        self._params = {k: v.detach().clone().requires_grad_(True)
                        for k, v in pmap.to_dict().items()}
        self.opt = make(list(self._params.values()))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._params

    @params.setter
    def params(self, values):
        with torch.no_grad():
            for k, v in values.items():
                self._params[k].copy_(torch.as_tensor(v))

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self, grads: Optional[Dict[str, torch.Tensor]] = None):
        """One step, from ``grads`` (a dict, as the reference takes them)
        or from each parameter's ``.grad`` (after ``loss.backward()``).
        Returns the parameters."""
        if grads is not None:
            for k, p in self._params.items():
                p.grad = torch.as_tensor(grads[k], dtype=p.dtype,
                                         device=p.device).detach().clone()
        self.opt.step()
        return self._params

    def update_scene(self) -> SceneData:
        """Push the values back into the scene (``params.update()``)."""
        self.pmap.scene = self.pmap.updated_scene(
            {k: v.detach().clone() for k, v in self._params.items()})
        return self.pmap.scene


def SGD(pmap: ParameterMap, lr: float = 0.1, momentum: float = 0.0):
    """Stochastic gradient descent: ``optax.sgd(lr, momentum)``'s steps
    (the trace ``t = g + momentum * t``, then ``-lr * t``)."""
    return _Optimizer(pmap, lambda ps: torch.optim.SGD(
        ps, lr=lr, momentum=momentum))


class _OptaxAdam(torch.optim.Optimizer):
    """Adam with ``optax.adam``'s arithmetic. torch's ``Adam`` takes the
    same step in exact arithmetic (it divides sqrt(v) by sqrt(1 - b2^t)
    before adding eps, the same denominator), but optax mixes precisions:
    its moments weight the gradient by 1 - b2 taken in float64, its bias
    correction 1 - b2^t in float32, where it cancels: with b2 = 0.999 its
    first step is 6e-6 shorter than torch's. This takes optax's
    operations in optax's order and precision:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
        p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    """

    def __init__(self, params, lr, b1, b2, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ('lr', 'b1', 'b2', 'eps'))
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st['count'] = 0
                    st['mu'] = torch.zeros_like(p)
                    st['nu'] = torch.zeros_like(p)
                st['count'] += 1
                mu = (1 - b1) * g + b1 * st['mu']
                nu = (1 - b2) * (g * g) + b2 * st['nu']
                st['mu'], st['nu'] = mu, nu
                t = torch.tensor(st['count'], dtype=torch.int32)
                bc1 = (1 - torch.tensor(b1, dtype=p.dtype) ** t).to(p.device)
                bc2 = (1 - torch.tensor(b2, dtype=p.dtype) ** t).to(p.device)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                p.add_(-lr * upd)


def Adam(pmap: ParameterMap, lr: float = 0.01, beta_1: float = 0.9,
         beta_2: float = 0.999):
    """Adam: ``optax.adam(lr, b1, b2)``'s steps (``_OptaxAdam``)."""
    return _Optimizer(pmap, lambda ps: _OptaxAdam(ps, lr, beta_1, beta_2))


def render_torch(scene, meta, spp: int = 1, seed: int = 0,
                 integrator: Optional[str] = None, param_keys=None):
    """A callable mapping parameter tensors (in ``param_keys`` order) to
    the image, differentiable in each (the reference's ``render_torch``;
    here without a bridge, the render being torch). ``call.param_keys``
    and ``call.initial_values`` give the keys and the scene's values."""
    pm = ParameterMap(scene, keys=param_keys)
    keys = pm.keys()

    def call(*tensors):
        return render(scene, meta, params=dict(zip(keys, tensors)),
                      pmap=pm, spp=spp, seed=seed, integrator=integrator)

    call.param_keys = keys
    call.initial_values = [pm[k].detach().clone() for k in keys]
    return call
