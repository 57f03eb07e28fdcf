"""Repository-wide pytest settings: the order in which pytest-xdist hands
out the suite under ``--dist loadfile``.

xdist makes each test file one work unit and queues the units by their
count of tests, the most first. The suite's longest files hold few tests
(``tests/test_autodiff.py``: 8 tests, 620-1,010 s on one worker), so they
went out late and set the wall. Here each test of ``SPLIT_FILES`` is a
work unit of its own, and the units named in ``UNIT_SECONDS`` go out
first, the longest first; the rest follow in xdist's own order. Every
test still runs once, nothing is selected or skipped, and a file that
stays one unit keeps its tests' order. Without xdist (``-p no:xdist``,
``-n 0``) the hook is never called and nothing changes.

``MNT_TEST_CLOCK_LOG=path`` appends one JSON line per test to ``path``
(its worker, and its start and end on the controller's clock), which
``scripts/port_test_clock.py`` summarises.
"""
import json
import os
import time

import pytest

SPLIT_FILES = ("tests/test_autodiff.py", "tests/test_nlvrl.py")

# Seconds of each unit on one worker of the six-worker Tier-1 run (the
# junit report of a run on an 8-core host): every test of the split
# files, then the heaviest whole files. Only the order matters: the split
# files' short tests go out before the whole files left to xdist's order,
# so no test of a split file is left for the end.
UNIT_SECONDS = {
    "tests/test_autodiff.py::test_unbiased_mode_decorrelates_gradients": 243.2,
    "tests/test_autodiff.py::test_grad_heterogeneous_grid_density": 108.9,
    "tests/test_autodiff.py::test_dryrun_multichip_entrypoint": 106.5,
    "tests/test_nlvrl.py::test_vrl_heterogeneous_medium_matches_volpath": 89.8,
    "tests/test_autodiff.py::test_grad_matches_finite_difference": 78.3,
    "tests/test_nlvrl.py::test_bre_heterogeneous_transmittance": 76.5,
    "tests/test_nlvrl.py::test_vrl_aniso_cdf_sampling": 58.2,
    "tests/test_autodiff.py::test_grad_medium_sigma_t_volpath": 52.5,
    "tests/test_nlvrl.py::test_bre_per_photon_radii": 52.1,
    "tests/test_nlvrl.py::test_vrl_dice_long_rr_unbiased": 51.6,
    "tests/test_nlvrl.py::test_vrl_matches_volpath": 43.8,
    "tests/test_nlvrl.py::test_vrl_uniform_sampling_prop_unbiased": 40.2,
    "tests/test_nlvrl.py::test_photonmapper_matches_volpath": 38.5,
    "tests/test_nlvrl.py::test_vrl_cluster_sampling_heterogeneous_variance": 30.3,
    "tests/test_nlvrl.py::test_constant_emitter_lighttrace_matches_volpath": 27.1,
    "tests/test_nlvrl.py::test_lighttrace_deposits": 25.6,
    "tests/test_nlvrl.py::test_vrl_cluster_sampling_unbiased_and_lower_variance": 20.3,
    "tests/test_nlvrl.py::test_light_depth_truncation_counter": 19.6,
    "tests/test_autodiff.py::test_render_torch_bridge": 14.7,
    "tests/test_autodiff.py::test_grad_emitter_radiance": 11.4,
    "tests/test_nlvrl.py::test_directional_emitter_lighttrace_deposits": 8.4,
    "tests/test_autodiff.py::test_sharded_render_matches_single_device": 8.0,
    "tests/test_nlvrl.py::test_snell_refraction_at_cell_boundary": 4.5,
    "tests/test_nlvrl.py::test_hashgrid_matches_bruteforce": 4.4,
    "tests/test_nlvrl.py::test_nonlinear_marcher_mirage_bending": 2.8,
    "tests/test_nlvrl.py::test_nonlinear_uniform_ior_goes_straight": 1.1,
    "tests/test_nlvrl.py::test_nlvrl_headline_scene_smoke": 0.0,
    "tests/test_polarization.py": 170.9,
    "tests/test_torch_autodiff.py": 124.9,
    "tests/test_spectral_polarized.py": 104.6,
    "tests/test_sharded_maps.py": 100.8,
    "tests/test_torch_bsdf_rough.py": 93.8,
    "tests/test_torch_vrl.py": 89.3,
    "tests/test_torch_vrl_options.py": 87.2,
    "tests/test_torch_bsdf_grad.py": 83.8,
    "tests/test_torch_medium.py": 75.0,
    "tests/test_measured_pol.py": 74.7,
    "tests/test_torch_volpath.py": 66.8,
    "tests/test_volpath.py": 66.6,
    "tests/test_measured.py": 64.5,
    "tests/test_torch_spectral.py": 61.6,
    "tests/test_torch_textured_render.py": 56.5,
    "tests/test_bench.py": 50.2,
    "tests/test_spectral.py": 49.6,
    "tests/test_torch_regen.py": 49.5,
    "tests/test_torch_measured.py": 47.7,
    "tests/test_torch_imports.py": 45.1,
    "tests/test_torch_bitmap_native.py": 99.6,
    "tests/test_torch_tiff_corners.py": 13.9,
}


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongestFirst(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = nodeid.split("::", 1)[0]
            return nodeid if path in SPLIT_FILES else path

        def _assign_work_unit(self, node):
            # The queue is whole by the first assignment: reorder it once.
            if not getattr(self, "_longest_first", False):
                self._longest_first = True
                named = sorted((s for s in self.workqueue
                                if s in UNIT_SECONDS),
                               key=lambda s: UNIT_SECONDS[s])
                for scope in named:
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return LongestFirst(config, log)


def _clock_log():
    # The controller logs; an xdist worker reports to it instead.
    if os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    return os.environ.get("MNT_TEST_CLOCK_LOG")


_started = {}


def pytest_runtest_logstart(nodeid, location):
    if _clock_log():
        _started[nodeid] = time.time()


def pytest_runtest_logreport(report):
    path = _clock_log()
    if not path or report.when != "teardown":
        return
    node = getattr(report, "node", None)
    worker = node.gateway.id if node is not None else "main"
    with open(path, "a") as f:
        f.write(json.dumps({"nodeid": report.nodeid, "worker": worker,
                            "start": _started.pop(report.nodeid, None),
                            "end": time.time()}) + "\n")
