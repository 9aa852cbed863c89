"""The G1 flat-velocity env with mixed explicit actuator groups: the
registered Mjlab-Velocity-Flat-Unitree-G1 config with its robot's
actuators and events changed (not a registered task).

Each group keeps the G1's own stiffness, damping, effort limit and
armature (asset_zoo/robots/unitree_g1/g1_constants.py):

- legs (the 7520-14, 7520-22 and ankle groups): a DC motor behind a
  position delay of 0-2 physics steps (hold 0.2, resampled every 2
  steps at a per-env phase), saturation_effort the effort limit and
  velocity_limit the group's motor's;
- arms and waist (the 5020 and waist groups): ideal PD;
- wrists (4010): the builtin position actuator, with
  actuator_forcerange, gainprm and biasprm carried per env
  (``expand_actuator_fields``, before the first step or capture), so that
  the PD-gain and effort-limit events have per-env fields to write.

Events added: randomize_pd_gains and randomize_effort_limits on reset
(scales 0.8-1.2), sync_actuator_delays at startup (lags 0-2), and
apply_external_force_torque every 1-3 s on the torso (force +-20 N,
torque +-5 N m); the nan_detection termination; the NaN guard on. The
scene's Model is g1_velocity_flat_explicit.npz beside this file (motors
for the DC and PD groups, position actuators for the wrists). Regenerate
it, on a machine with MuJoCo, with

    python -m mjlab_tpu_torch.tasks.velocity.config.g1.explicit

``GROUPS`` and the ``*_PARAMS`` dicts are the configuration as plain data,
from which the tests build the JAX package's twin.
"""

from __future__ import annotations

from pathlib import Path

from mjlab_tpu_torch.asset_zoo.robots.unitree_g1 import g1_constants as g1
from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnv, ManagerBasedRlEnvCfg

EXPLICIT_MODEL = Path(__file__).resolve().parent / "g1_velocity_flat_explicit.npz"

# the per-env model fields of the builtin group
EXPANDED_FIELDS = ("actuator_forcerange", "actuator_gainprm", "actuator_biasprm")

# (kind, the G1 group, its motor's velocity limit); kind "delayed_dc", "pd"
# or "builtin"
GROUPS = (
    ("pd", g1.G1_ACTUATOR_5020, g1.ACTUATOR_5020.velocity_limit),
    ("delayed_dc", g1.G1_ACTUATOR_7520_14, g1.ACTUATOR_7520_14.velocity_limit),
    ("delayed_dc", g1.G1_ACTUATOR_7520_22, g1.ACTUATOR_7520_22.velocity_limit),
    ("builtin", g1.G1_ACTUATOR_4010, g1.ACTUATOR_4010.velocity_limit),
    ("pd", g1.G1_ACTUATOR_WAIST, g1.ACTUATOR_5020.velocity_limit),
    ("delayed_dc", g1.G1_ACTUATOR_ANKLE, g1.ACTUATOR_5020.velocity_limit),
)

DELAY_PARAMS = dict(delay_target="position", min_lag=0, max_lag=2, hold_prob=0.2,
                    update_period=2, per_env_phase=True)
PD_GAIN_PARAMS = dict(stiffness_scale=(0.8, 1.2), damping_scale=(0.8, 1.2))
EFFORT_PARAMS = dict(scale=(0.8, 1.2))
LAG_PARAMS = dict(min_lag=0, max_lag=2)
WRENCH_INTERVAL_S = (1.0, 3.0)
WRENCH_PARAMS = dict(force_range=(-20.0, 20.0), torque_range=(-5.0, 5.0))
WRENCH_BODY = "torso_link"


def explicit_actuators() -> tuple:
    """The robot's actuator groups (see the module docstring)."""
    from mjlab_tpu_torch.actuator.dc import DcMotorActuatorCfg
    from mjlab_tpu_torch.actuator.delayed import DelayedActuatorCfg
    from mjlab_tpu_torch.actuator.pd import IdealPdActuatorCfg

    out = []
    for kind, a, vmax in GROUPS:
        common = dict(joint_names_expr=a.joint_names_expr, stiffness=a.stiffness,
                      damping=a.damping, effort_limit=a.effort_limit, armature=a.armature)
        if kind == "builtin":
            out.append(a)
        elif kind == "pd":
            out.append(IdealPdActuatorCfg(**common))
        else:
            base = DcMotorActuatorCfg(**common, saturation_effort=a.effort_limit,
                                      velocity_limit=vmax)
            out.append(DelayedActuatorCfg(joint_names_expr=a.joint_names_expr,
                                          base_cfg=base, **DELAY_PARAMS))
    return tuple(out)


def g1_explicit_env_cfg() -> ManagerBasedRlEnvCfg:
    """The config (see the module docstring)."""
    from mjlab_tpu_torch.envs.mdp import events, terminations
    from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg, TerminationTermCfg
    from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
    from mjlab_tpu_torch.tasks.velocity.config.g1.env_cfgs import unitree_g1_flat_env_cfg
    from mjlab_tpu_torch.utils.nan_guard import NanGuardCfg

    cfg = unitree_g1_flat_env_cfg()
    cfg.scene.entities["robot"].actuators = explicit_actuators()
    cfg.scene.model_file = EXPLICIT_MODEL
    cfg.events["pd_gains"] = EventTermCfg(
        func=events.randomize_pd_gains, mode="reset", params=dict(PD_GAIN_PARAMS))
    cfg.events["effort_limits"] = EventTermCfg(
        func=events.randomize_effort_limits, mode="reset", params=dict(EFFORT_PARAMS))
    cfg.events["actuator_delays"] = EventTermCfg(
        func=events.sync_actuator_delays, mode="startup", params=dict(LAG_PARAMS))
    cfg.events["external_wrench"] = EventTermCfg(
        func=events.apply_external_force_torque, mode="interval",
        interval_range_s=WRENCH_INTERVAL_S,
        params=dict(WRENCH_PARAMS, asset_cfg=SceneEntityCfg("robot", body_names=(WRENCH_BODY,))))
    cfg.terminations["nan_term"] = TerminationTermCfg(func=terminations.nan_detection)
    cfg.sim.nan_guard = NanGuardCfg(enabled=True)
    return cfg


def expand_actuator_fields(env) -> None:
    """Carry EXPANDED_FIELDS per env (before the first step or capture)."""
    env.sim.expand_model_fields(list(EXPANDED_FIELDS))


def make_g1_explicit_env(num_envs: int, device="cuda", capture: bool = True,
                         seed: int | None = None, nan_dir: str | None = None,
                         cfg: ManagerBasedRlEnvCfg | None = None) -> ManagerBasedRlEnv:
    """The env of num_envs envs on device, its fields expanded; nan_dir:
    the NaN guard's output directory."""
    cfg = cfg if cfg is not None else g1_explicit_env_cfg()
    cfg.scene.num_envs = num_envs
    if seed is not None:
        cfg.seed = seed
    if nan_dir is not None:
        cfg.sim.nan_guard.output_dir = nan_dir
    env = ManagerBasedRlEnv(cfg, device=device, capture=capture)
    expand_actuator_fields(env)
    return env


def save_model_file() -> None:
    """Compile the scene with MuJoCo, convert it and write EXPLICIT_MODEL."""
    from mjlab_tpu_torch.scene.scene import save_scene_model
    from mjlab_tpu_torch.tasks.velocity.config.g1.physics import sim_cfg

    save_scene_model(EXPLICIT_MODEL, g1_explicit_env_cfg().scene, sim_cfg())


if __name__ == "__main__":
    save_model_file()
    print(f"wrote {EXPLICIT_MODEL} ({EXPLICIT_MODEL.stat().st_size} bytes)")
