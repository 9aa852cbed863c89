"""The G1 flat-velocity env whose critic reads every builtin sensor type:
the registered Mjlab-Velocity-Flat-Unitree-G1 config (4096 envs, dt 0.005,
decimation 4, the task's PPO config) with a sensor suite added (not a
registered task).

The suite, on the G1's own objects (``BUILTIN_SENSORS``, plain data):
every builtin type but the tendon types, and upvector, on the sites
imu_in_pelvis, imu_in_torso, left_foot and right_foot, the leg joints and
their actuators, and the pelvis and torso bodies; framepos, framequat and
framelinvel each with a reference frame; one sensor with a cutoff. The
rangefinder reads along the z axis of a site this config adds to the
pelvis (``RANGEFINDER_SITE``, 16 cm below the pelvis frame, pointing
down: no G1 site points at the ground), so that its ray meets the floor.
Three contact sensors of the feet against the terrain
(``contact_sensor_cfgs``): reduce "maxforce" with every field but dist
and two slots, "mindist" in the world frame, and "none" with a force per
slot. The critic group reads every builtin sensor (the XML's four too)
through observations.builtin_sensor and the contact sensors through
``contact_fields``; the actor group is the task's. ``add_sensor_suite``
puts the suite on any G1 env config; ``critic_columns`` and
``reading_class`` name the critic's columns and the tolerance class of
what each reads, for the checks against a reference.

The scene's Model is g1_velocity_flat_sensors.npz beside this file (the
flat scene with the added site). Regenerate it, on a machine with
MuJoCo, with

    python -m mjlab_tpu_torch.tasks.velocity.config.g1.sensors
"""

from __future__ import annotations

from pathlib import Path

import torch

from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnv, ManagerBasedRlEnvCfg

SENSORS_MODEL = Path(__file__).resolve().parent / "g1_velocity_flat_sensors.npz"

# the rangefinder's site: on the pelvis, its z axis down (a half turn
# about x)
RANGEFINDER_SITE = ("pelvis", "rangefinder_down", (0.0, 0.0, -0.16), (0.0, 1.0, 0.0, 0.0))

# (name, type, (object kind, object name), (reference kind, name) or None,
# cutoff); object names are the robot entity's
BUILTIN_SENSORS = (
    ("torso_force", "force", ("site", "imu_in_torso"), None, 0.0),
    ("left_foot_force", "force", ("site", "left_foot"), None, 0.0),
    ("torso_torque", "torque", ("site", "imu_in_torso"), None, 0.0),
    ("right_foot_torque", "torque", ("site", "right_foot"), None, 0.0),
    ("pelvis_magnetometer", "magnetometer", ("site", "imu_in_pelvis"), None, 0.0),
    ("pelvis_range", "rangefinder", ("site", RANGEFINDER_SITE[1]), None, 0.0),
    ("torso_accelerometer", "accelerometer", ("site", "imu_in_torso"), None, 0.0),
    ("torso_gyro", "gyro", ("site", "imu_in_torso"), None, 0.0),
    ("torso_velocimeter", "velocimeter", ("site", "imu_in_torso"), None, 0.0),
    ("left_hip_pitch_pos", "jointpos", ("joint", "left_hip_pitch_joint"), None, 0.0),
    ("left_knee_vel", "jointvel", ("joint", "left_knee_joint"), None, 0.0),
    ("left_knee_limit_pos", "jointlimitpos", ("joint", "left_knee_joint"), None, 0.0),
    ("left_knee_limit_vel", "jointlimitvel", ("joint", "left_knee_joint"), None, 0.0),
    ("left_knee_limit_frc", "jointlimitfrc", ("joint", "left_knee_joint"), None, 0.0),
    ("right_ankle_pitch_limit_pos", "jointlimitpos", ("joint", "right_ankle_pitch_joint"),
     None, 0.0),
    ("right_ankle_pitch_limit_frc", "jointlimitfrc", ("joint", "right_ankle_pitch_joint"),
     None, 0.0),
    ("left_knee_actuator_frc", "jointactuatorfrc", ("joint", "left_knee_joint"), None, 0.0),
    ("left_knee_act_pos", "actuatorpos", ("actuator", "left_knee_joint"), None, 0.0),
    ("left_knee_act_vel", "actuatorvel", ("actuator", "left_knee_joint"), None, 0.0),
    ("left_knee_act_frc", "actuatorfrc", ("actuator", "left_knee_joint"), None, 0.0),
    ("left_foot_pos", "framepos", ("site", "left_foot"), ("body", "pelvis"), 0.0),
    ("torso_quat", "framequat", ("body", "torso_link"), ("site", "imu_in_pelvis"), 0.0),
    ("pelvis_quat", "framequat", ("xbody", "pelvis"), None, 0.0),
    ("torso_xaxis", "framexaxis", ("site", "imu_in_torso"), None, 0.0),
    ("torso_yaxis", "frameyaxis", ("site", "imu_in_torso"), None, 0.0),
    ("left_foot_zaxis", "framezaxis", ("site", "left_foot"), ("xbody", "pelvis"), 0.0),
    ("right_foot_linvel", "framelinvel", ("site", "right_foot"), ("xbody", "pelvis"), 0.0),
    ("torso_angvel", "frameangvel", ("xbody", "torso_link"), None, 0.0),
    ("left_foot_linacc", "framelinacc", ("site", "left_foot"), None, 50.0),
    ("torso_angacc", "frameangacc", ("body", "torso_link"), None, 0.0),
    ("pelvis_up", "upvector", ("site", "imu_in_pelvis"), None, 0.0),
    ("pelvis_subtree_com", "subtreecom", ("body", "pelvis"), None, 0.0),
    ("torso_subtree_linvel", "subtreelinvel", ("body", "torso_link"), None, 0.0),
    ("torso_subtree_angmom", "subtreeangmom", ("body", "torso_link"), None, 0.0),
    ("potential_energy", "e_potential", None, None, 0.0),
    ("kinetic_energy", "e_kinetic", None, None, 0.0),
    ("clock", "clock", None, None, 0.0),
)
# the sensors the G1 XML declares (the scene wraps them under these names)
XML_SENSORS = ("robot/imu_ang_vel", "robot/imu_lin_vel", "robot/imu_lin_acc",
               "robot/root_angmom")

FEET = r"^(left_ankle_roll_link|right_ankle_roll_link)$"
# (name, reduce, fields, num_slots, global_frame)
CONTACT_SENSORS = (
    ("feet_maxforce", "maxforce", ("found", "force", "torque", "pos", "normal", "tangent"),
     2, False),
    ("feet_mindist_world", "mindist",
     ("found", "force", "torque", "dist", "pos", "normal", "tangent"), 1, True),
    ("feet_none", "none", ("found", "force"), 2, False),
)
# the contact fields in the order contact_fields flattens them
CONTACT_FIELDS = ("found", "force", "torque", "dist", "pos", "normal", "tangent")

# What each reading reads, the class a check of the port against a
# reference maps to its tolerance: "position" (positions, frames, axes,
# joint angles, distances, the potential energy), "force" (accelerations
# and constraint forces), "velocity" (every other builtin type:
# velocities, momenta, the kinetic energy, the clock, actuator forces);
# a contact field's: "count" (found), "position" (dist, pos, normal,
# tangent), "slot_force" (a slot's force and torque, which the solver's
# convergence spreads over a foot's contacts)
READING_CLASS = {
    **dict.fromkeys(("framepos", "framequat", "framexaxis", "frameyaxis", "framezaxis",
                     "upvector", "jointpos", "jointlimitpos", "actuatorpos", "subtreecom",
                     "magnetometer", "rangefinder", "e_potential"), "position"),
    **dict.fromkeys(("accelerometer", "force", "torque", "framelinacc", "frameangacc",
                     "jointlimitfrc"), "force"),
}
CONTACT_FIELD_CLASS = {"found": "count", "dist": "position", "pos": "position",
                       "normal": "position", "tangent": "position", "force": "slot_force",
                       "torque": "slot_force"}
# the column whose largest entry scales the slot forces
SLOT_FORCE_SCALE = "contact/feet_maxforce.force"


def add_rangefinder_site(spec):
    """The spec edit: RANGEFINDER_SITE on its body (a mujoco.MjSpec)."""
    body, name, pos, quat = RANGEFINDER_SITE
    spec.body(body).add_site(name=name, pos=list(pos), quat=list(quat))
    return spec


def builtin_sensor_cfgs() -> tuple:
    from mjlab_tpu_torch.sensor.builtin_sensor import BuiltinSensorCfg, ObjRef

    def ref(o):
        return None if o is None else ObjRef(type=o[0], name=o[1], entity="robot")

    return tuple(BuiltinSensorCfg(name=n, sensor_type=t, obj=ref(o), ref=ref(r), cutoff=c)
                 for n, t, o, r, c in BUILTIN_SENSORS)


def contact_sensor_cfgs() -> tuple:
    from mjlab_tpu_torch.sensor.contact_sensor import ContactMatch, ContactSensorCfg

    return tuple(ContactSensorCfg(
        name=n, primary=ContactMatch(mode="subtree", pattern=FEET, entity="robot"),
        secondary=ContactMatch(mode="body", pattern="terrain/terrain"), fields=f,
        reduce=r, num_slots=k, global_frame=g) for n, r, f, k, g in CONTACT_SENSORS)


def contact_fields(env, sensor_name: str) -> torch.Tensor:
    """A contact sensor's fields (CONTACT_FIELDS order, those it has) as
    one (num_envs, n) float32 block: found as a count, the vectors
    flattened row by row."""
    data = env.scene[sensor_name].data
    parts = []
    for f in CONTACT_FIELDS:
        x = getattr(data, f)
        if x is not None:
            parts.append(x.reshape(x.shape[0], -1).to(torch.float32))
    return torch.cat(parts, dim=-1)


def add_sensor_suite(cfg: ManagerBasedRlEnvCfg,
                     model_file: Path | None = SENSORS_MODEL) -> ManagerBasedRlEnvCfg:
    """The suite on a G1 env config, in place: the rangefinder site, the
    builtin and contact sensors, and the critic terms that read them.
    ``model_file``: the scene compiled with the site (None: compiled with
    MuJoCo at build)."""
    from mjlab_tpu_torch.envs.mdp import observations
    from mjlab_tpu_torch.managers.manager_term_config import ObservationTermCfg

    robot = cfg.scene.entities["robot"]
    spec_fn = robot.spec_fn
    robot.spec_fn = lambda: add_rangefinder_site(spec_fn())
    cfg.scene.sensors = tuple(cfg.scene.sensors) + builtin_sensor_cfgs() + contact_sensor_cfgs()
    cfg.scene.model_file = model_file
    terms = cfg.observations["critic"].terms
    for name in XML_SENSORS + tuple(s[0] for s in BUILTIN_SENSORS):
        terms[f"sensor/{name}"] = ObservationTermCfg(
            func=observations.builtin_sensor, params={"sensor_name": name})
    for name, *_ in CONTACT_SENSORS:
        terms[f"contact/{name}"] = ObservationTermCfg(
            func=contact_fields, params={"sensor_name": name})
    return cfg


def g1_sensors_env_cfg() -> ManagerBasedRlEnvCfg:
    """The config (see the module docstring)."""
    from mjlab_tpu_torch.tasks.velocity.config.g1.env_cfgs import unitree_g1_flat_env_cfg

    return add_sensor_suite(unitree_g1_flat_env_cfg())


def make_g1_sensors_env(num_envs: int, device="cuda", capture: bool = True,
                        seed: int | None = None,
                        cfg: ManagerBasedRlEnvCfg | None = None) -> ManagerBasedRlEnv:
    """The env of num_envs envs on device."""
    cfg = cfg if cfg is not None else g1_sensors_env_cfg()
    cfg.scene.num_envs = num_envs
    if seed is not None:
        cfg.seed = seed
    return ManagerBasedRlEnv(cfg, device=device, capture=capture)


def critic_columns(env) -> dict[str, slice]:
    """The critic's columns by term, in the group's order: a contact
    sensor's term by field ("contact/<name>.<field>")."""
    cols, c = {}, 0
    for name, tcfg in env.observation_manager._group_terms["critic"].items():
        if name.startswith("contact/"):
            data = env.scene[name[len("contact/"):]].data
            parts = [(f"{name}.{f}", getattr(data, f)) for f in CONTACT_FIELDS
                     if getattr(data, f) is not None]
        else:
            parts = [(name, tcfg.func(env, **tcfg.params))]
        for key, x in parts:
            w = int(x.reshape(x.shape[0], -1).shape[1])
            cols[key] = slice(c, c + w)
            c += w
    return cols


def reading_class(env, column: str) -> str | None:
    """The class of a critic column (critic_columns): a builtin sensor's
    by its type (READING_CLASS, "velocity" where it lists none), a contact
    field's by CONTACT_FIELD_CLASS; None for the task's own terms."""
    if column.startswith("sensor/"):
        return READING_CLASS.get(env.scene[column[len("sensor/"):]].cfg.sensor_type, "velocity")
    if column.startswith("contact/"):
        return CONTACT_FIELD_CLASS[column.rsplit(".", 1)[1]]
    return None


def save_model_file() -> None:
    """Compile the scene with MuJoCo, convert it and write SENSORS_MODEL."""
    from mjlab_tpu_torch.scene.scene import save_scene_model
    from mjlab_tpu_torch.tasks.velocity.config.g1.physics import sim_cfg

    save_scene_model(SENSORS_MODEL, g1_sensors_env_cfg().scene, sim_cfg())


if __name__ == "__main__":
    save_model_file()
    print(f"wrote {SENSORS_MODEL} ({SENSORS_MODEL.stat().st_size} bytes)")
