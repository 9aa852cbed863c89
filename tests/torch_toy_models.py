"""Small models the card tests run the kernels on, kept as files in
tests/models/ because the card's machine has no MuJoCo. The two solve
kernels run on (NAMES):

- eq_toy: the joint-equality toy (EQ_XML, tests/torch_port_common.py)
  with condim 3 contacts, under the pyramidal cone (the fused pyramidal
  solve builds its rows from the frame's two tangents: condim <= 3, as
  the TPU kernel does, solver_pallas2.py:110-121);
- nolimit_toy: the toy (TOY_XML) without joint limits, pyramidal;
- nolimit_ell_toy: the elliptic toy (ELL_XML: condim 6, impratio 10, a
  joint equality) without joint limits.

The smooth kernels (kin_com, vel_smooth) also run on (SMOOTH_NAMES):

- joint_toy: the refresh model of tests/test_torch_step.py (REFRESH_XML
  of tests/torch_port_common.py:
  free, ball, hinge and slide joints, a two-joint body, a multi-geom
  body) with a spring on every joint, a position actuator on the hinge, a
  force-limited motor on the slide and the implicitfast integrator, so
  that every branch of the two kernels runs.

Each file is the port's Model (float64 values) of the compiled XML at
nconmax 12. Regenerate them, on a machine with MuJoCo, with

    python tests/torch_toy_models.py

tests/test_torch_newton_launch.py checks each against a fresh conversion.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

DIR = Path(__file__).resolve().parent / "models"
NAMES = ("eq_toy", "nolimit_toy", "nolimit_ell_toy")
SMOOTH_NAMES = ("joint_toy",)
ALL = NAMES + SMOOTH_NAMES
NCONMAX = 12
_NO_LIMITS = ((' range="-1 1"', ""), (' range="-2 0.5"', ""))
_JOINT_TOY = (
    ('<option timestep="0.002"/>', '<option timestep="0.002" integrator="implicitfast"/>'),
    ("<freejoint/>", '<joint type="free" stiffness="0.3"/>'),
    ('type="ball" damping="0.1"', 'type="ball" damping="0.1" stiffness="0.5"'),
    ('axis="0 1 0" damping="0.05"', 'axis="0 1 0" damping="0.05" stiffness="0.4" springref="0.2"'),
    ('axis="1 0 0" damping="0.05"', 'axis="1 0 0" damping="0.05" stiffness="2"'),
    ("</worldbody>", """</worldbody>
  <actuator>
    <position joint="flex" kp="5" kv="0.3" ctrlrange="-1 1"/>
    <motor joint="ext" gear="2" forcerange="-0.5 0.5"/>
  </actuator>"""),
)


def xml(name: str) -> str:
    from torch_port_common import ELL_XML, EQ_XML, REFRESH_XML, TOY_XML

    def strip(text, pairs):
        for old, new in pairs:
            assert old in text, old
            text = text.replace(old, new)
        return text

    if name == "eq_toy":
        return strip(EQ_XML, ((' condim="6" ', " "),))
    if name == "nolimit_toy":
        return strip(TOY_XML, _NO_LIMITS)
    if name == "nolimit_ell_toy":
        return strip(ELL_XML, _NO_LIMITS)
    if name == "joint_toy":
        return strip(REFRESH_XML, _JOINT_TOY)
    raise KeyError(name)


def convert(name: str):
    """The port's Model of the compiled XML (float64, CPU)."""
    import mujoco

    from mjlab_tpu_torch.phys import model as pm

    mj = mujoco.MjModel.from_xml_string(xml(name))
    return pm.put_model(mj, dtype=torch.float64, nconmax=NCONMAX, device="cpu")


def main() -> int:
    from mjlab_tpu_torch.phys import model as pm

    DIR.mkdir(exist_ok=True)
    for name in ALL:
        path = DIR / f"{name}.npz"
        pm.save_model(path, convert(name))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent)]
    sys.exit(main())
