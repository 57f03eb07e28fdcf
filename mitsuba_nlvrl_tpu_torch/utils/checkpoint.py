"""Checkpoint and resume of a long render.

Port of ``mitsuba_nlvrl_tpu/utils/checkpoint.py`` over ``torch.save`` and
``torch.load`` (the reference writes through orbax): the state of a
render between passes, its film accumulator, the passes done, the seed,
a two-pass integrator's photon and VRL maps (as ``maps_to_numpy`` arrays)
and any extra parameters, so a render cut short resumes to the image the
uninterrupted render makes.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_render_state(path: str, film_acc, passes_done: int, seed: int,
                      aux=None, extra: Optional[Dict[str, Any]] = None):
    """Write an in-progress render (between passes). The tensors go to the
    host; ``aux`` is a two-pass integrator's maps."""
    from ..integrators.vrl import maps_to_numpy
    state = {'film_acc': film_acc.detach().cpu(),
             'passes_done': int(passes_done), 'seed': int(seed)}
    if aux is not None:
        state['aux'] = maps_to_numpy(aux)
    if extra:
        state['extra'] = {k: v.detach().cpu() if torch.is_tensor(v) else v
                          for k, v in extra.items()}
    tmp = f'{path}.tmp'
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_render_state(path: str, device=None) -> dict:
    """The saved dict (film_acc, passes_done, seed, and aux and extra
    where saved), its tensors on ``device`` (the maps rebuilt there)."""
    from ..integrators.vrl import maps_from_numpy
    st = torch.load(path, map_location='cpu', weights_only=False)
    st['film_acc'] = st['film_acc'].to(device)
    if 'aux' in st:
        st['aux'] = maps_from_numpy(st['aux'], device=device)
    return st


def render_with_checkpoints(scene, meta, seed: int = 0, spp=None,
                            ckpt_path: Optional[str] = None,
                            ckpt_every: int = 16):
    """``render`` that writes its state every ``ckpt_every`` passes (and
    after the last) and resumes from ``ckpt_path`` where it exists: the
    same passes with the same keys, summed in the same order."""
    from .. import film as film_mod
    from ..core import rng
    from ..render import preprocess, render_pass
    spp = spp or meta.spp
    key = rng.PRNGKey(seed)
    start, acc, aux = 0, None, None
    if ckpt_path and os.path.exists(ckpt_path):
        st = load_render_state(ckpt_path, scene.device)
        acc, start, aux = st['film_acc'], st['passes_done'], st.get('aux')
    if aux is None:
        with torch.no_grad():
            aux = preprocess(scene, meta, seed)
    for p in range(start, spp):
        img, _ = render_pass(scene, meta, rng.fold_in(key, p), p, aux)
        acc = img if acc is None else acc + img
        if ckpt_path and ((p + 1) % ckpt_every == 0 or p + 1 == spp):
            save_render_state(ckpt_path, acc, p + 1, seed, aux)
    return film_mod.develop(acc)
