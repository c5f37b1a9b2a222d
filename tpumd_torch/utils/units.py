"""Unit systems.

Reproduces the unit-style constant tables of the reference
(src/update.cpp:137-330 ``Update::set_units``): conversion factors, default
timestep and default neighbor skin per style.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Units:
    name: str
    boltz: float
    hplanck: float
    mvv2e: float
    ftm2v: float
    mv2d: float
    nktv2p: float
    qqr2e: float
    qe2f: float
    dt: float          # default timestep
    skin: float        # default neighbor skin
    # time unit in femtoseconds (for ns/day style reporting); 0 => reduced ("tau")
    femtosecond: float = 0.0
    # length of 1 Angstrom / charge of 1 electron in these units
    # (src/update.cpp force->angstrom / force->qelectron)
    angstrom: float = 1.0
    qelectron: float = 1.0


_UNITS = {
    "lj": Units(
        name="lj", boltz=1.0, hplanck=1.0, mvv2e=1.0, ftm2v=1.0, mv2d=1.0,
        nktv2p=1.0, qqr2e=1.0, qe2f=1.0, dt=0.005, skin=0.3, femtosecond=0.0,
    ),
    "real": Units(
        name="real", boltz=0.0019872067, hplanck=95.306976368,
        mvv2e=48.88821291 * 48.88821291, ftm2v=1.0 / 48.88821291 / 48.88821291,
        mv2d=1.0 / 0.602214129, nktv2p=68568.415, qqr2e=332.06371,
        qe2f=23.060549, dt=1.0, skin=2.0, femtosecond=1.0,
    ),
    "metal": Units(
        name="metal", boltz=8.617343e-5, hplanck=4.135667403e-3,
        mvv2e=1.0364269e-4, ftm2v=1.0 / 1.0364269e-4,
        mv2d=1.0 / 0.602214129, nktv2p=1.6021765e6, qqr2e=14.399645,
        qe2f=1.0, dt=0.001, skin=2.0, femtosecond=1.0e-3,
    ),
    "si": Units(
        name="si", boltz=1.3806504e-23, hplanck=6.62606896e-34, mvv2e=1.0,
        ftm2v=1.0, mv2d=1.0, nktv2p=1.0, qqr2e=8.9876e9, qe2f=1.0,
        dt=1.0e-8, skin=0.001, femtosecond=1.0e-15,
        angstrom=1.0e-10, qelectron=1.6021765e-19,
    ),
    "cgs": Units(
        name="cgs", boltz=1.3806504e-16, hplanck=6.62606896e-27, mvv2e=1.0,
        ftm2v=1.0, mv2d=1.0, nktv2p=1.0, qqr2e=1.0, qe2f=1.0,
        dt=1.0e-8, skin=0.1, femtosecond=1.0e-15,
        angstrom=1.0e-8, qelectron=4.8032044e-10,
    ),
    "electron": Units(
        name="electron", boltz=3.16681534e-6, hplanck=0.1519829846,
        mvv2e=1.06657236, ftm2v=0.937582899, mv2d=1.0, nktv2p=2.94210108e13,
        qqr2e=1.0, qe2f=1.94469051e-10, dt=0.001, skin=2.0, femtosecond=1.0,
        angstrom=1.88972612,
    ),
    "micro": Units(
        name="micro", boltz=1.3806504e-8, hplanck=6.62606896e-13, mvv2e=1.0,
        ftm2v=1.0, mv2d=1.0, nktv2p=1.0, qqr2e=8.987556e6, qe2f=1.0,
        dt=2.0, skin=0.1, femtosecond=1.0e-9,
        angstrom=1.0e-4, qelectron=1.6021765e-7,
    ),
    "nano": Units(
        name="nano", boltz=0.013806504, hplanck=6.62606896e-4, mvv2e=1.0,
        ftm2v=1.0, mv2d=1.0, nktv2p=1.0, qqr2e=230.7078669, qe2f=1.0,
        dt=0.00045, skin=0.1, femtosecond=1.0e-6,
        angstrom=1.0e-1,
    ),
}


def get_units(style: str) -> Units:
    try:
        return _UNITS[style]
    except KeyError:
        raise ValueError(f"Unknown units style: {style!r}") from None
