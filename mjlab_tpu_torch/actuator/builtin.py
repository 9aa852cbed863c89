"""MuJoCo builtin position actuator: the spec edit and the runtime.

PyTorch-package counterpart of mjlab_tpu/actuator/builtin.py
(``BuiltinPositionActuatorCfg`` and ``BuiltinPositionActuator``) and of
mjlab_tpu/utils/spec.py:create_position_actuator. The PD law is an affine
gain/bias that the physics step evaluates, and the implicitfast integrator
treats its damping term implicitly; at run time the actuator passes the
joint position target through to ctrl.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from mjlab_tpu_torch.actuator.actuator import Actuator, ActuatorCmd

if TYPE_CHECKING:
    import mujoco


def create_position_actuator(
    spec: "mujoco.MjSpec",
    joint_name: str,
    *,
    stiffness: float,
    damping: float,
    effort_limit: float | None = None,
    armature: float = 0.0,
    frictionloss: float = 0.0,
) -> "mujoco.MjsActuator":
    """Affine PD <position> actuator on a joint (gainprm kp; biasprm -kp,
    -kd), ctrl unlimited; sets the joint's armature and frictionloss."""
    import mujoco

    a = spec.add_actuator(name=joint_name, target=joint_name)
    a.trntype = mujoco.mjtTrn.mjTRN_JOINT
    a.dyntype = mujoco.mjtDyn.mjDYN_NONE
    a.gaintype = mujoco.mjtGain.mjGAIN_FIXED
    a.biastype = mujoco.mjtBias.mjBIAS_AFFINE
    a.gainprm[0] = stiffness
    a.biasprm[1] = -stiffness
    a.biasprm[2] = -damping
    a.ctrllimited = False
    if effort_limit is not None:
        a.forcelimited = True
        a.forcerange[:] = (-effort_limit, effort_limit)
    else:
        a.forcelimited = False
    j = spec.joint(joint_name)
    j.armature = armature
    j.frictionloss = frictionloss
    return a


@dataclass(kw_only=True)
class BuiltinPositionActuatorCfg:
    joint_names_expr: tuple[str, ...]
    stiffness: float
    damping: float
    effort_limit: float | None = None
    armature: float = 0.0
    frictionloss: float = 0.0

    def build(self, joint_ids, joint_names) -> "BuiltinPositionActuator":
        return BuiltinPositionActuator(self, joint_ids, joint_names)

    def edit_spec(self, spec: "mujoco.MjSpec", joint_names) -> None:
        """Add one position actuator per joint, in the given order."""
        for name in joint_names:
            create_position_actuator(
                spec,
                name,
                stiffness=self.stiffness,
                damping=self.damping,
                effort_limit=self.effort_limit,
                armature=self.armature,
                frictionloss=self.frictionloss,
            )


class BuiltinPositionActuator(Actuator):
    """ctrl = the joint position target (the physics computes the force)."""

    is_passthrough = True
    target = "position"

    def compute(self, state, cmd: ActuatorCmd):
        return cmd.position_target
