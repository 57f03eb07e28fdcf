"""Named IORs and conductors.

Port of ``mitsuba_nlvrl_tpu/scene/ior_data.py`` (``lookup_ior``,
``load_spd``, ``conductor_rgb``). Standard material IOR values (public
physical constants) serve scene files that write e.g. int_ior="bk7". A
named conductor's complex IOR comes from ``<name>.eta.spd`` and
``<name>.k.spd`` in the directory ``MNT_IOR_DIR`` names; without it
``conductor_rgb`` returns None and the BSDF keeps its eta/k defaults, as
the reference does when its data directory is absent.
"""

IOR_TABLE = {
    'vacuum': 1.0,
    'helium': 1.000036,
    'hydrogen': 1.000132,
    'air': 1.000277,
    'carbon dioxide': 1.00045,
    'water': 1.3330,
    'acetone': 1.36,
    'ethanol': 1.361,
    'carbon tetrachloride': 1.461,
    'glycerol': 1.4729,
    'benzene': 1.501,
    'silicone oil': 1.52045,
    'bromine': 1.661,
    'water ice': 1.31,
    'fused quartz': 1.458,
    'pyrex': 1.470,
    'acrylic glass': 1.49,
    'polypropylene': 1.49,
    'bk7': 1.5046,
    'sodium chloride': 1.544,
    'amber': 1.55,
    'pet': 1.5750,
    'diamond': 2.419,
}


def lookup_ior(name):
    if isinstance(name, (int, float)):
        return float(name)
    try:
        return float(name)
    except ValueError:
        pass
    key = name.strip().lower()
    if key not in IOR_TABLE:
        raise KeyError(f"unknown IOR material {name!r}")
    return IOR_TABLE[key]



# --- named conductor materials (<name>.{eta,k}.spd) ---------------------------

import os as _os
import re as _re


def _spd_dirs():
    d = _os.environ.get('MNT_IOR_DIR', '')
    return [d] if d else []


def load_spd(path):
    """Parse a two-column .spd file -> (wavelengths_nm, values) lists:
    whitespace- or comma-separated, '#' comments."""
    wav, val = [], []
    with open(path, 'r', errors='replace') as f:
        for line in f:
            line = line.split('#')[0].strip()
            if not line:
                continue
            parts = _re.split(r'[\s,]+', line)
            if len(parts) < 2:
                continue
            try:
                w, v = float(parts[0]), float(parts[1])
            except ValueError:
                continue
            wav.append(w)
            val.append(v)
    return wav, val


def _find_spd(name, which):
    for d in _spd_dirs():
        p = _os.path.join(d, f'{name}.{which}.spd')
        if _os.path.exists(p):
            return p
    return None


_CONDUCTOR_CACHE = {}


def conductor_rgb(name):
    """(eta_rgb, k_rgb) for a named conductor: the tabulated complex-IOR
    spectra CIE-integrated to linear sRGB, as every other spectrum enters
    the RGB variant. 'none' is the perfect-mirror default. Returns None
    when no data directory has the material (the caller keeps its
    defaults and warns)."""
    key = name.strip()
    if key.lower() == 'none':
        return (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    if key in _CONDUCTOR_CACHE:
        return _CONDUCTOR_CACHE[key]
    pe, pk = _find_spd(key, 'eta'), _find_spd(key, 'k')
    if pe is None or pk is None:
        return None
    from ..core.spectrum import spectrum_to_rgb
    we, ve = load_spd(pe)
    wk, vk = load_spd(pk)
    eta = tuple(spectrum_to_rgb(we, ve, bounded=False))
    k = tuple(spectrum_to_rgb(wk, vk, bounded=False))
    _CONDUCTOR_CACHE[key] = (eta, k)
    return eta, k


_SPD_CURVES = []     # (2, CIE_SAMPLES) float32 eta/k rows, append-only
_SPD_ID_CACHE = {}


def conductor_spd_id(name):
    """Register a named conductor's tabulated eta/k curves resampled onto
    the CIE wavelength grid; returns a stable row id into ``spd_curves()``,
    or None when no .spd data exists. The spectral variants lerp these
    curves at the hero wavelengths, so the conductor's Fresnel term is
    evaluated a wavelength at a time."""
    key = name.strip()
    if key.lower() == 'none':
        return None
    if key in _SPD_ID_CACHE:
        return _SPD_ID_CACHE[key]
    pe, pk = _find_spd(key, 'eta'), _find_spd(key, 'k')
    if pe is None or pk is None:
        return None
    import numpy as np
    from ..core.cie_data import CIE_MIN, CIE_MAX, CIE_SAMPLES
    grid = np.linspace(CIE_MIN, CIE_MAX, CIE_SAMPLES)
    we, ve = load_spd(pe)
    wk, vk = load_spd(pk)
    eta = np.interp(grid, we, ve)
    k = np.interp(grid, wk, vk)
    _SPD_CURVES.append(np.stack([eta, k]).astype(np.float32))
    i = len(_SPD_CURVES) - 1
    _SPD_ID_CACHE[key] = i
    return i


def spd_curves():
    """Every registered conductor curve, (C, 2, CIE_SAMPLES) numpy, or None
    when no named conductor has been seen."""
    import numpy as np
    if not _SPD_CURVES:
        return None
    return np.stack(_SPD_CURVES)
