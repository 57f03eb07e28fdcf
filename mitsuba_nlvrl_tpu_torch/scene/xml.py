"""Mitsuba scene XML loader.

Port of ``mitsuba_nlvrl_tpu/scene/xml.py`` (itself a replacement for the
reference's src/libcore/xml.cpp): parses both legacy (v0.4-0.6,
camelCase) and Mitsuba-2 (v2.0, snake_case) scene files into the same
description dict the reference's loader returns, with the port's own
``Transform`` (float32 numpy matrices). Covers the tag set
scene/integrator/sensor/sampler/film/rfilter/shape/bsdf/emitter/medium/
phase/texture/volume/spectrum/rgb/float/integer/boolean/string/vector/
point/transform/ref/default/include/alias/path.

Spectra outside emitters are integrated to linear sRGB at load time as
the RGB variants do (``core/spectrum.spectrum_to_rgb``); emitter spectra
stay dicts, and ``emitter.pack_params`` integrates them.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from ..core import transform as tr
from ..core.spectrum import spectrum_to_rgb, blackbody_rgb
from .ior_data import lookup_ior

_CAMEL_RE = re.compile(r'(?<!^)(?=[A-Z])')


def _snake(name: str) -> str:
    return _CAMEL_RE.sub('_', name).lower()


# legacy / upgraded property-name aliases per plugin family
_ALIASES = {
    'diffuse_reflectance': 'reflectance',
    'sigma_a': 'sigma_a',
    'focus_distance': 'focus_distance',
}

# spectral quantities that are unbounded (xml.cpp is_unbounded_spectrum)
_UNBOUNDED = {'radiance', 'intensity', 'irradiance', 'sigma_t', 'sigma_a',
              'sigma_s', 'eta', 'k', 'value', 'power'}


def _parse_floats(s: str) -> List[float]:
    return [float(x) for x in re.split(r'[,\s]+', s.strip()) if x]


def _parse_xml_file(path: str):
    """ET.parse tolerating junk after the root element (some scene files
    carry leftover shapes below </scene>, which pugixml's default mode
    ignores too)."""
    try:
        return ET.parse(path).getroot()
    except ET.ParseError:
        text = open(path, 'r', errors='replace').read()
        end = text.find('</scene>')
        if end < 0:
            raise
        return ET.fromstring(text[:end + len('</scene>')])


def _parse_spectrum(value: str, within_emitter: bool, name: str):
    """Parse a <spectrum value=...>: either wavelength:value pairs or a
    uniform value. Emitter SPDs stay dicts (the spectral variant samples
    them; RGB mode integrates at pack time); others integrate to rgb."""
    if ':' in value:
        pairs = [p for p in re.split(r'[,\s]+', value.strip()) if p]
        wav, vals = [], []
        for p in pairs:
            w, v = p.split(':')
            wav.append(float(w))
            vals.append(float(v))
        if within_emitter:
            return {'type': 'irregular', 'value': list(zip(wav, vals))}
        bounded = name not in _UNBOUNDED
        return tuple(spectrum_to_rgb(wav, vals, bounded=bounded))
    parts = [p for p in re.split(r'[,\s]+', value.strip()) if p]
    if len(parts) == 3:
        # comma/space triple without wavelengths: treat as RGB (thesis
        # scene files use this shorthand, e.g. cboxtest.xml reflectance)
        return tuple(float(p) for p in parts)
    v = float(value)
    return (v, v, v)


class XMLContext:
    def __init__(self, base_dir: str, params: Optional[Dict[str, str]] = None,
                 substitutions: Optional[Dict[str, str]] = None):
        self.base_dir = base_dir
        self.defaults: Dict[str, str] = dict(params or {})
        self.named: Dict[str, dict] = {}     # id -> description dict
        # missing-asset substitution: basename -> replacement path (for
        # checkouts that lack some data files)
        self.substitutions: Dict[str, str] = dict(substitutions or {})
        # extra <path value=.../> search directories (the reference's
        # FileResolver tag, xml.cpp "path" handling): consulted after the
        # scene file's own directory
        self.search_paths: list = []

    def resolve(self, fname: str) -> str:
        base = os.path.basename(fname)
        if base in self.substitutions:
            return self.substitutions[base]
        if os.path.isabs(fname):
            return fname
        primary = os.path.join(self.base_dir, fname)
        if not os.path.exists(primary):
            for sp in self.search_paths:
                cand = os.path.join(sp, fname)
                if os.path.exists(cand):
                    return cand
        return primary

    def subst(self, s: str) -> str:
        def repl(mt):
            key = mt.group(1)
            if key not in self.defaults:
                raise KeyError(f"undefined scene parameter ${key}")
            return self.defaults[key]
        return re.sub(r'\$([A-Za-z_][A-Za-z0-9_]*)', repl, s)


def _parse_transform(elem, ctx: XMLContext) -> tr.Transform:
    """Children compose in document order: each op pre-multiplies onto the
    accumulated transform (reference xml.cpp transform parsing)."""
    T = tr.Transform.identity()
    for ch in elem:
        tag = ch.tag.lower()
        g = lambda k, d=None: ctx.subst(ch.get(k)) if ch.get(k) is not None else d
        if tag == 'translate':
            if g('value') is not None:
                v = _parse_floats(g('value'))
            else:
                v = [float(g('x', '0')), float(g('y', '0')), float(g('z', '0'))]
            T = tr.translate(v) @ T
        elif tag == 'scale':
            if g('value') is not None:
                v = _parse_floats(g('value'))
                v = v * 3 if len(v) == 1 else v
            else:
                v = [float(g('x', '1')), float(g('y', '1')), float(g('z', '1'))]
            T = tr.scale(v) @ T
        elif tag == 'rotate':
            angle = float(g('angle', '0'))
            if g('value') is not None:
                axis = _parse_floats(g('value'))
            else:
                axis = [float(g('x', '0')), float(g('y', '0')), float(g('z', '0'))]
            T = tr.rotate(axis, angle) @ T
        elif tag in ('lookat', 'look_at'):
            T = tr.look_at(_parse_floats(g('origin')),
                           _parse_floats(g('target')),
                           _parse_floats(g('up', '0, 1, 0'))) @ T
        elif tag == 'matrix':
            vals = _parse_floats(g('value'))
            if len(vals) == 9:
                M = np.eye(4)
                M[:3, :3] = np.asarray(vals).reshape(3, 3)
            else:
                M = np.asarray(vals).reshape(4, 4)
            T = tr.Transform.from_matrix(M) @ T
        else:
            raise ValueError(f"unknown transform op <{tag}>")
    return T


_OBJECT_TAGS = {'integrator', 'sensor', 'sampler', 'film', 'rfilter',
                'shape', 'bsdf', 'emitter', 'medium', 'phase', 'texture',
                'volume'}


def _parse_object(elem, ctx: XMLContext, within_emitter=False) -> dict:
    """Parse an object tag (+nested properties/children) into a dict."""
    props: dict = {'type': ctx.subst(elem.get('type', ''))}
    if elem.get('id'):
        props['id'] = elem.get('id')
    tag = elem.tag.lower()
    is_emitter = tag == 'emitter' or within_emitter

    for ch in elem:
        ctag = ch.tag.lower()
        rawname = ch.get('name', '')
        name = _snake(ctx.subst(rawname)) if rawname else ''
        name = _ALIASES.get(name, name)
        g = lambda k, d=None: ctx.subst(ch.get(k)) if ch.get(k) is not None else d

        if ctag == 'float':
            props[name] = float(g('value'))
        elif ctag == 'integer':
            props[name] = int(g('value'))
        elif ctag == 'boolean':
            props[name] = g('value').lower() == 'true'
        elif ctag == 'string':
            val = g('value')
            if name == 'filename':
                val = ctx.resolve(val)
            props[name] = val
        elif ctag in ('vector', 'point'):
            if g('value') is not None:
                props[name] = tuple(_parse_floats(g('value')))
            else:
                props[name] = (float(g('x', '0')), float(g('y', '0')),
                               float(g('z', '0')))
        elif ctag == 'rgb':
            v = _parse_floats(g('value'))
            props[name] = tuple(v * 3 if len(v) == 1 else v)
        elif ctag == 'spectrum':
            if ch.get('filename'):
                wav, vals = [], []
                with open(ctx.resolve(g('filename'))) as f:
                    for line in f:
                        line = line.strip()
                        if not line or line.startswith('#'):
                            continue
                        w, v = line.split()[:2]
                        wav.append(float(w)); vals.append(float(v))
                if is_emitter:
                    # keep the SPD so the spectral variant can sample it;
                    # emitter pack_params integrates to RGB for RGB mode
                    props[name] = {'type': 'irregular',
                                   'value': list(zip(wav, vals))}
                else:
                    bounded = name not in _UNBOUNDED
                    props[name] = tuple(spectrum_to_rgb(wav, vals,
                                                        bounded=bounded))
            else:
                props[name] = _parse_spectrum(g('value'), is_emitter, name)
        elif ctag == 'blackbody':
            temp = float(g('temperature'))
            scale_v = float(g('scale', '1'))
            if is_emitter:
                props[name] = {'type': 'blackbody', 'temperature': temp,
                               'scale': scale_v}
            else:
                props[name] = tuple(scale_v * blackbody_rgb(temp))
        elif ctag == 'transform':
            props[name or 'to_world'] = _parse_transform(ch, ctx)
        elif ctag == 'ref':
            rid = ch.get('id')
            if rid not in ctx.named:
                raise KeyError(f"<ref id={rid!r}>: unknown id")
            target = ctx.named[rid]
            refname = name or {'bsdf': 'bsdf', 'medium': 'interior',
                               'emitter': 'emitter',
                               'shape': 'shapegroup'}.get(
                                   target.get('_tag', ''), 'bsdf')
            props[refname] = target
        elif ctag in _OBJECT_TAGS:
            sub = _parse_object(ch, ctx, within_emitter=is_emitter
                                or ctag == 'emitter')
            sub['_tag'] = ctag
            if ch.get('id'):
                ctx.named[ch.get('id')] = sub
            key = name if name else ctag
            if ctag == 'medium' and name in ('interior', 'exterior'):
                key = name
            if key in props:  # repeated children (e.g. blendbsdf's 2 bsdfs)
                cur = props[key]
                props[key] = (cur + [sub]) if isinstance(cur, list) \
                    else [cur, sub]
            else:
                props[key] = sub
        elif ctag == 'default':
            ctx.defaults.setdefault(ch.get('name'), ch.get('value'))
        elif ctag == 'include':
            raise ValueError("<include> only allowed at scene level")
        else:
            raise ValueError(f"unknown tag <{ctag}> in <{tag}>")

    # named IOR strings ("bk7", "diamond", "air", ...) are accepted by the
    # whole dielectric/plastic family (reference ior.h lookup_ior)
    for k in ('int_ior', 'ext_ior'):
        if isinstance(props.get(k), str):
            props[k] = lookup_ior(props[k])
    return props


def _predeclare(root, ctx: XMLContext):
    """First pass: register scene-level named objects (bsdf/medium/emitter/
    texture) and defaults so forward <ref>s resolve (the reference loader
    builds the full Properties tree before instantiation, allowing
    forward references within a file)."""
    for ch in root:
        tag = ch.tag.lower()
        if tag == 'default':
            ctx.defaults.setdefault(ch.get('name'), ch.get('value'))
        elif tag == 'include':
            fname = ctx.resolve(ctx.subst(ch.get('filename')))
            sub_tree = _parse_xml_file(fname)
            old = ctx.base_dir
            # the reference's FileResolver keeps the ORIGINAL scene dir
            # searchable inside includes (nested includes name paths
            # relative to the top-level scene)
            ctx.search_paths.append(old)
            ctx.base_dir = os.path.dirname(fname)
            _predeclare(sub_tree, ctx)
            ctx.base_dir = old
            ctx.search_paths.pop()
        elif tag in ('bsdf', 'medium', 'emitter', 'texture') and ch.get('id'):
            obj = _parse_object(ch, ctx, within_emitter=(tag == 'emitter'))
            obj['_tag'] = tag
            ctx.named[ch.get('id')] = obj


def _parse_scene_elem(root, ctx: XMLContext, desc: dict, declared=None):
    """Second pass: shapes / sensor / integrator / unnamed emitters."""
    for ch in root:
        tag = ch.tag.lower()
        if tag == 'default':
            ctx.defaults.setdefault(ch.get('name'), ch.get('value'))
        elif tag == 'include':
            fname = ctx.resolve(ctx.subst(ch.get('filename')))
            sub_tree = _parse_xml_file(fname)
            sub_ctx_dir = os.path.dirname(fname)
            old = ctx.base_dir
            ctx.search_paths.append(old)   # see _predeclare include note
            ctx.base_dir = sub_ctx_dir
            _parse_scene_elem(sub_tree, ctx, desc)
            ctx.base_dir = old
            ctx.search_paths.pop()
        elif tag == 'integrator':
            desc['integrator'] = _parse_object(ch, ctx)
        elif tag == 'sensor':
            sensor = _parse_object(ch, ctx)
            # hoist nested sampler/film
            desc['sensor'] = sensor
        elif tag == 'shape':
            sh = _parse_object(ch, ctx)
            sh['_tag'] = 'shape'
            if ch.get('id'):
                ctx.named[ch.get('id')] = sh
            desc.setdefault('shapes', []).append(sh)
        elif tag in ('bsdf', 'medium', 'texture'):
            if not ch.get('id'):  # id'd objects were predeclared in pass 1
                _parse_object(ch, ctx)
        elif tag == 'emitter':
            if not ch.get('id'):
                e = _parse_object(ch, ctx, within_emitter=True)
                e['_tag'] = 'emitter'
                desc.setdefault('emitters', []).append(e)
            else:
                # id'd scene-level emitters were predeclared; non-area ones
                # (envmap/constant/point/...) are still scene emitters —
                # only id'd AREA emitters get attached via shape <ref>s
                e = ctx.named[ch.get('id')]
                if e.get('type') != 'area':
                    desc.setdefault('emitters', []).append(e)
        elif tag == 'alias':
            ctx.named[ch.get('as')] = ctx.named[ch.get('id')]
        elif tag == 'path':
            # <path value="..."/>: extra file-resolver search directory
            # (relative to the current scene file)
            p = ctx.subst(ch.get('value', ''))
            if not os.path.isabs(p):
                p = os.path.normpath(os.path.join(ctx.base_dir, p))
            ctx.search_paths.append(p)
        else:
            raise ValueError(f"unknown scene-level tag <{tag}>")


def load_file(path: str, params: Optional[Dict[str, str]] = None,
              substitutions: Optional[Dict[str, str]] = None) -> dict:
    """Load a Mitsuba XML scene file into a scene description dict
    (consumed by scene.builder.build_scene). ``substitutions`` maps asset
    basenames to replacement paths (for checkouts with missing data)."""
    root = _parse_xml_file(path)
    if root.tag != 'scene':
        raise ValueError(f"{path}: root tag must be <scene>")
    ctx = XMLContext(os.path.dirname(os.path.abspath(path)), params,
                     substitutions)
    desc: dict = {}
    _predeclare(root, ctx)
    _parse_scene_elem(root, ctx, desc)
    _fixup(desc, ctx)
    return desc


def load_string(text: str, base_dir: str = '.',
                params: Optional[Dict[str, str]] = None) -> dict:
    root = ET.fromstring(text)
    ctx = XMLContext(base_dir, params)
    desc: dict = {}
    _predeclare(root, ctx)
    _parse_scene_elem(root, ctx, desc)
    _fixup(desc, ctx)
    return desc


def _fixup(desc: dict, ctx: XMLContext):
    """Resolve scene-level emitters referenced by shapes (area emitter
    declared standalone with id, attached via <ref>), and shapes whose
    emitter is scene-level."""
    # shapes that referenced an emitter dict pick it up as 'emitter' already;
    # scene-level unreferenced area emitters without shapes are invalid.
    ems = desc.get('emitters', [])
    desc['emitters'] = [e for e in ems if e.get('type') != 'area']
    # drop helper keys
    def scrub(d):
        if isinstance(d, dict):
            d.pop('_tag', None)
            for v in d.values():
                scrub(v)
        elif isinstance(d, list):
            for v in d:
                scrub(v)
    scrub(desc)
