"""Style registry: name -> constructor (the reference's style_pair.h
factory, src/force.cpp:237-254).  Styles register themselves at import."""

from __future__ import annotations

_PAIR_STYLES = {}


def register_pair(name):
    def deco(cls):
        _PAIR_STYLES[name] = cls
        return cls
    return deco


def create_pair_style(name: str, ntypes: int, args):
    import tpumd_torch.models.pair_lj_cut  # noqa: F401 (registers lj/cut)
    if name not in _PAIR_STYLES:
        raise NotImplementedError(f"pair_style {name!r} is not ported")
    style = _PAIR_STYLES[name](ntypes)
    style.settings(*[_num(a) for a in args])
    return style


def _num(tok):
    try:
        return float(tok)
    except (TypeError, ValueError):
        return tok
