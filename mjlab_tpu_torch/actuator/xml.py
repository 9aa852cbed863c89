"""XML actuators: the <position>, <motor> and <velocity> actuators the
robot XML already declares, passed through.

PyTorch counterpart of mjlab_tpu/actuator/xml.py: ctrl is the joint's
position, effort or velocity target; the spec edit finds the actuator that
targets each joint and overrides the joint's armature and frictionloss
where the config sets them.
"""

from __future__ import annotations

from dataclasses import dataclass

from mjlab_tpu_torch.actuator.actuator import Actuator, ActuatorCfg, ActuatorCmd


def _edit_xml_spec(cfg: ActuatorCfg, spec, joint_names) -> None:
    by_joint = {a.target: a for a in spec.actuators}
    for name in joint_names:
        if name not in by_joint:
            raise ValueError(f"no XML actuator targets joint '{name}'")
        if cfg.armature:
            spec.joint(name).armature = cfg.armature
        if cfg.frictionloss:
            spec.joint(name).frictionloss = cfg.frictionloss


class XmlActuator(Actuator):
    """ctrl = the target named by ``target``."""

    is_passthrough = True

    def __init__(self, cfg, joint_ids, joint_names, target: str):
        super().__init__(cfg, joint_ids, joint_names)
        self.target = target

    def compute(self, state, cmd: ActuatorCmd, rng=None):
        return {"position": cmd.position_target, "velocity": cmd.velocity_target,
                "effort": cmd.effort_target}[self.target]


@dataclass(kw_only=True)
class XmlPositionActuatorCfg(ActuatorCfg):
    def build(self, joint_ids, joint_names) -> XmlActuator:
        return XmlActuator(self, joint_ids, joint_names, "position")

    def edit_spec(self, spec, joint_names) -> None:
        _edit_xml_spec(self, spec, joint_names)


@dataclass(kw_only=True)
class XmlMotorActuatorCfg(ActuatorCfg):
    def build(self, joint_ids, joint_names) -> XmlActuator:
        return XmlActuator(self, joint_ids, joint_names, "effort")

    def edit_spec(self, spec, joint_names) -> None:
        _edit_xml_spec(self, spec, joint_names)


@dataclass(kw_only=True)
class XmlVelocityActuatorCfg(ActuatorCfg):
    def build(self, joint_ids, joint_names) -> XmlActuator:
        return XmlActuator(self, joint_ids, joint_names, "velocity")

    def edit_spec(self, spec, joint_names) -> None:
        _edit_xml_spec(self, spec, joint_names)
