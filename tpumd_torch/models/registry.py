"""Style registry: name -> constructor (the reference's style_pair.h and
style_bond.h/angle/dihedral/improper factories, src/force.cpp:237-254).
Styles register themselves at import."""

from __future__ import annotations

_PAIR_STYLES = {}
# kind -> {name: class}
_BONDED_STYLES = {"bond": {}, "angle": {}, "dihedral": {}, "improper": {}}


def register_pair(name):
    def deco(cls):
        _PAIR_STYLES[name] = cls
        return cls
    return deco


def register_bonded(kind: str, name: str):
    table = _BONDED_STYLES[kind]

    def deco(cls):
        table[name] = cls
        return cls
    return deco


def create_pair_style(name: str, ntypes: int, args, units=None):
    # the pair modules register their styles at import
    import tpumd_torch.models.pair_breadth2  # noqa: F401
    import tpumd_torch.models.pair_charmm  # noqa: F401
    import tpumd_torch.models.pair_eam  # noqa: F401
    import tpumd_torch.models.pair_gran  # noqa: F401
    import tpumd_torch.models.pair_hybrid  # noqa: F401
    import tpumd_torch.models.pair_lj_cut  # noqa: F401
    import tpumd_torch.models.pair_misc  # noqa: F401
    import tpumd_torch.models.pair_table  # noqa: F401
    if name not in _PAIR_STYLES:
        raise NotImplementedError(f"pair_style {name!r} is not ported")
    style = _PAIR_STYLES[name](ntypes)
    style.units = units
    style.settings(*[_num(a) for a in args])
    return style


def create_bonded_style(kind: str, name: str, args, ntypes: int):
    import tpumd_torch.models.bonded  # noqa: F401 (registers the styles)
    table = _BONDED_STYLES.get(kind, {})
    if name not in table:
        raise NotImplementedError(f"{kind}_style {name!r} is not ported")
    if args:
        raise NotImplementedError(f"{kind}_style {name} takes no "
                                  f"arguments, got {list(args)}")
    return table[name](ntypes)


def _num(tok):
    try:
        return float(tok)
    except (TypeError, ValueError):
        return tok
