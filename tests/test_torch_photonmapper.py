"""Whole ``photonmapper`` renders of the port against the reference's: a
homogeneous box (anisotropic phase) and the nonlinear box of
``cbox_nlvrl`` (its 640-cell IOR grid and laser), 16x8 at 2 spp with the
knobs of ``torch_parity.TWO_PASS_KNOBS``.

The reference runs with IEEE rounding (``torch_parity.ieee_reference``):
the camera rays bend in the nonlinear medium and turn on the last bit at
every total internal reflection. Found:
  * on the reference's maps, carried over: every pixel within 1e-3
    relative (the worst 6e-8 absolute) and the ray counts equal, in both
    boxes;
  * on the port's own light pass (both packages shoot the same paths; the
    nonlinear box's maps differ where a total internal reflection after a
    scatter flips): the golden suite's z-test on every pixel, the means
    within 1e-3 relative.
Last, both integrators hand the kernel contiguous rays only.
"""
import pytest

from torch_parity import (check_render_on_reference_maps,
                          check_render_own_light_pass)

INTEGRATOR = 'photonmapper'
SPP = 2


@pytest.mark.parametrize('medium', ['homogeneous', 'nonlinear'])
def test_render_on_reference_maps_matches_reference(medium):
    check_render_on_reference_maps(INTEGRATOR, medium, SPP)


@pytest.mark.parametrize('medium', ['homogeneous', 'nonlinear'])
def test_render_own_light_pass_matches_reference(medium):
    check_render_own_light_pass(INTEGRATOR, medium, SPP)


@pytest.mark.parametrize('integrator', ['vrl', 'photonmapper'])
def test_render_hands_the_kernel_contiguous_rays(monkeypatch, integrator):
    """The wrapper refuses strided rays on the card, so every ray of the
    light pass, the bend march and the shadow walks must be contiguous
    float32 already; the calls are nearest hits and any hits on the
    box's 24 triangles."""
    import torch
    import mitsuba_nlvrl_tpu_torch as P
    from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
    from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_nlvrl
    calls = []
    plain = kern.intersect_tris_plain

    def check(*args, any_hit=False):
        assert all(x.is_contiguous() for x in args)
        assert all(x.dtype == torch.float32 for x in args)
        calls.append((args[0].shape[0], any_hit))
        return plain(*args, any_hit=any_hit)
    monkeypatch.setattr(pisect, 'intersect_tris', check)
    desc = cbox_nlvrl(8, 4, spp=1, target_vrls=64, integrator=integrator,
                      light_depth_cap=4, max_nl_bends=4, gather_points_cap=4,
                      max_cam_iters=3, global_photons=1024)
    scene, meta = P.build_scene(desc, device='cpu')
    P.render(scene, meta, seed=0, spp=1)
    assert set(calls) == {(24, False), (24, True)}
