"""Event term library: resets, pushes, external wrenches and domain
randomisation of model fields and actuator groups.

PyTorch counterpart of mjlab_tpu/envs/mdp/events.py: randomize_terrain,
reset_scene_to_default, reset_root_state_uniform, reset_joints_by_offset,
push_by_setting_velocity, apply_external_force_torque, randomize_field (on
the Model fields Simulation.expand_model_fields carries per env),
randomize_pd_gains, randomize_effort_limits, randomize_encoder_bias and
sync_actuator_delays. Every term takes (env, env_mask, **params) and
writes only the masked envs, in place (the entity view's writes, an
expanded Model field, or an actuator group's state), drawing from the
env's Rng in the JAX term's order. A DR write always starts from the
field's default value, so that resets do not accumulate.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.utils import math

__all__ = [
    "randomize_terrain",
    "reset_scene_to_default",
    "reset_root_state_uniform",
    "reset_joints_by_offset",
    "push_by_setting_velocity",
    "apply_external_force_torque",
    "randomize_field",
    "randomize_pd_gains",
    "randomize_effort_limits",
    "randomize_encoder_bias",
    "sync_actuator_delays",
    "FIELD_SPECS",
]

_DEFAULT = SceneEntityCfg("robot")


def _rand(rng, distribution, lo, hi, shape):
    if distribution == "uniform":
        return rng.uniform(shape, lo, hi)
    if distribution == "log_uniform":
        # the logs and their difference in float32, as the JAX term takes
        # them at its float32 default
        log_lo, log_hi = np.log(np.float32(lo)), np.log(np.float32(hi))
        u = rng.uniform(shape)
        return torch.exp(float(log_lo) + u * float(log_hi - log_lo))
    if distribution == "gaussian":
        return lo + hi * rng.normal(shape)
    raise ValueError(distribution)


# ---------------------------------------------------------------------------
# state resets
# ---------------------------------------------------------------------------


def randomize_terrain(env, env_mask):
    """A random sub-terrain level and type for each resetting env
    (mjlab_tpu/envs/mdp/events.py:56-61; the play variants' variety): two
    integer draws over every env, levels first
    (terrains/importer.py randomize_env_origins)."""
    terrain = env.scene.terrain
    if terrain is not None:
        terrain.randomize_env_origins(env_mask, env.rng)


def reset_scene_to_default(env, env_mask):
    """Every entity at its default state plus its env origin."""
    origins = env.scene.env_origins
    E = env.num_envs
    for entity in env.scene.entities.values():
        data = entity.data
        if not entity.is_fixed_base:
            default = data.default_root_state.expand(E, 13)
            pose = torch.cat([default[:, :3] + origins.to(default.dtype), default[:, 3:7]], -1)
            data.write_root_pose(pose, env_mask)
            data.write_root_velocity(default[:, 7:13], env_mask)
        if entity.is_articulated and entity.num_joints:
            J = entity.num_joints
            data.write_joint_state(data.default_joint_pos.expand(E, J),
                                   data.default_joint_vel.expand(E, J), env_ids=env_mask)


def _ranges(rng, table: dict, names, E):
    """One U[lo, hi) draw of (E,) per name, (0, 0) for names the table
    lacks."""
    return [rng.uniform((E,), *(table.get(n) or (0.0, 0.0))) for n in names]


def reset_root_state_uniform(
    env,
    env_mask,
    pose_range: dict[str, tuple] | None = None,
    velocity_range: dict[str, tuple] | None = None,
    asset_cfg: SceneEntityCfg = _DEFAULT,
):
    """The default root state plus the env origin plus a uniform pose and
    velocity offset (pose_range keys x y z roll pitch yaw)."""
    pose_range = pose_range or {}
    velocity_range = velocity_range or {}
    entity = env.scene[asset_cfg.name]
    data = entity.data
    E = env.num_envs
    default = data.default_root_state.expand(E, 13).to(torch.float32)
    dx, dy, dz, droll, dpitch, dyaw = _ranges(
        env.rng, pose_range, ("x", "y", "z", "roll", "pitch", "yaw"), E)
    pos = default[:, :3] + env.scene.env_origins.to(torch.float32) + torch.stack(
        [dx, dy, dz], -1)
    quat = math.quat_mul(math.quat_from_euler_xyz(droll, dpitch, dyaw), default[:, 3:7])
    vel = default[:, 7:13] + torch.stack(_ranges(
        env.rng, velocity_range, ("x", "y", "z", "roll", "pitch", "yaw"), E), -1)
    if entity.indexing.mocap_id is not None:
        data.write_mocap_pose(torch.cat([pos, quat], -1), env_mask)
    else:
        data.write_root_pose(torch.cat([pos, quat], -1), env_mask)
        data.write_root_velocity(vel, env_mask)


def reset_joints_by_offset(
    env,
    env_mask,
    position_range: tuple = (0.0, 0.0),
    velocity_range: tuple = (0.0, 0.0),
    asset_cfg: SceneEntityCfg = _DEFAULT,
):
    """The default joint state plus uniform offsets, positions clipped to
    the soft limits."""
    entity = env.scene[asset_cfg.name]
    data = entity.data
    E, J = env.num_envs, entity.num_joints
    jp = data.default_joint_pos.expand(E, J).to(torch.float32) + env.rng.uniform(
        (E, J), *position_range)
    jv = data.default_joint_vel.expand(E, J).to(torch.float32) + env.rng.uniform(
        (E, J), *velocity_range)
    lims = data.soft_joint_pos_limits.expand(E, J, 2).to(torch.float32)
    jp = torch.minimum(torch.maximum(jp, lims[..., 0]), lims[..., 1])
    data.write_joint_state(jp, jv, env_ids=env_mask)


def apply_external_force_torque(
    env,
    env_mask,
    force_range: tuple = (0.0, 0.0),
    torque_range: tuple = (0.0, 0.0),
    asset_cfg: SceneEntityCfg = _DEFAULT,
):
    """A sampled constant wrench (world force and torque at the com) on
    asset_cfg's bodies of the masked envs, written into xfrc_applied
    (mjlab_tpu/envs/mdp/events.py:183-210): force, then torque, each
    U[lo, hi) of (num_envs, bodies, 3)."""
    entity = env.scene[asset_cfg.name]
    ids = asset_cfg.body_ids
    nb = len(entity.indexing.body_ids) if isinstance(ids, slice) else int(ids.numel())
    E = env.num_envs
    force = env.rng.uniform((E, nb, 3), *force_range)
    torque = env.rng.uniform((E, nb, 3), *torque_range)
    entity.data.write_external_wrench(
        force, torque, body_ids=None if isinstance(ids, slice) else ids, env_ids=env_mask)


def randomize_encoder_bias(
    env,
    env_mask,
    bias_range: tuple = (0.0, 0.0),
    asset_cfg: SceneEntityCfg = _DEFAULT,
):
    """A per-episode joint encoder offset, U[lo, hi) per (env, joint) of
    asset_cfg's joints (the others keep theirs), written into the entity's
    encoder_bias in place (mjlab_tpu/envs/mdp/events.py:439-455);
    joint_pos_rel(biased=True) and the joint action read it."""
    entity = env.scene[asset_cfg.name]
    bias = entity.data.encoder_bias
    E, J = bias.shape
    new = env.rng.uniform((E, J), *bias_range).to(bias.dtype)
    ids = asset_cfg.joint_ids
    if not isinstance(ids, slice):
        keep = torch.ones(J, dtype=torch.bool, device=bias.device)
        keep[ids] = False
        new = torch.where(keep, bias, new)
    bias.copy_(torch.where(env_mask[:, None], new, bias))


def push_by_setting_velocity(
    env,
    env_mask,
    velocity_range: dict[str, tuple],
    asset_cfg: SceneEntityCfg = _DEFAULT,
):
    """The root velocity plus a sampled offset."""
    entity = env.scene[asset_cfg.name]
    data = entity.data
    delta = torch.stack(_ranges(env.rng, velocity_range,
                                ("x", "y", "z", "roll", "pitch", "yaw"), env.num_envs), -1)
    vel = data.root_link_vel_w
    data.write_root_velocity(vel + delta.to(vel.dtype), env_mask)


# ---------------------------------------------------------------------------
# domain randomisation over model fields
# ---------------------------------------------------------------------------

# field -> (id kind, component axes in the trailing dim or None)
FIELD_SPECS: dict[str, tuple[str, tuple | None]] = {
    "geom_friction": ("geom", None),
    "geom_solref": ("geom", None),
    "geom_solimp": ("geom", None),
    "body_mass": ("body", None),
    "body_ipos": ("body", None),
    "body_inertia": ("body", None),
    "dof_damping": ("dof", None),
    "dof_armature": ("dof", None),
    "dof_frictionloss": ("dof", None),
    "jnt_stiffness": ("joint", None),
    "actuator_gainprm": ("actuator", None),
    "actuator_biasprm": ("actuator", None),
    "qpos0": ("qpos", None),
}


def _resolve_field_ids(entity, field: str, asset_cfg: SceneEntityCfg) -> torch.Tensor:
    """The global Model rows of the entity's elements asset_cfg selects."""
    kind, _ = FIELD_SPECS[field]
    idx = entity.indexing
    sel, base = {
        "geom": (asset_cfg.geom_ids, idx.geom_ids),
        "body": (asset_cfg.body_ids, idx.body_ids),
        "dof": (asset_cfg.joint_ids, idx.joint_v_adr),
        "joint": (asset_cfg.joint_ids, idx.joint_ids),
        "actuator": (asset_cfg.actuator_ids, idx.ctrl_ids),
        "qpos": (asset_cfg.joint_ids, idx.joint_q_adr),
    }[kind]
    return base if isinstance(sel, slice) else base[sel]


def randomize_field(
    env,
    env_mask,
    field: str,
    ranges: tuple | dict,
    distribution: Literal["uniform", "log_uniform", "gaussian"] = "uniform",
    operation: Literal["add", "scale", "abs"] = "scale",
    axes: tuple | None = None,
    asset_cfg: SceneEntityCfg = _DEFAULT,
):
    """Randomise a per-env Model field: one draw per (env, element),
    combined with the field's default value and written into the
    expanded field in place. ``ranges`` is a (lo, hi) applied to ``axes``
    (all components when None), or {component: (lo, hi)}."""
    entity = env.scene[asset_cfg.name]
    ids = _resolve_field_ids(entity, field, asset_cfg)
    cur = getattr(env.sim.model, field)
    E = env.num_envs
    if cur.ndim == 0 or cur.shape[0] != E:
        raise RuntimeError(
            f"field '{field}' is not env-expanded; mark the event term with "
            "domain_randomization=True")
    sub_default = env.sim.get_default_field(field)[ids].to(torch.float32)  # (n, ...)
    shape = (E,) + tuple(sub_default.shape)
    if isinstance(ranges, dict):
        ncomp = sub_default.shape[-1]
        lo = np.zeros(ncomp, np.float32)
        hi = np.zeros(ncomp, np.float32)
        comp = np.zeros(ncomp, bool)
        for a, (lo_a, hi_a) in ranges.items():
            lo[int(a)], hi[int(a)], comp[int(a)] = lo_a, hi_a, True
        lo_t, hi_t = env.const(lo), env.const(hi)
        sample = lo_t + env.rng.uniform(shape) * (hi_t - lo_t)
        comp_mask = env.const(comp, torch.bool)
    else:
        sample = _rand(env.rng, distribution, ranges[0], ranges[1], shape)
        comp_mask = None
        if axes is not None and sub_default.ndim > 1:
            comp = np.zeros(sub_default.shape[-1], bool)
            comp[list(axes)] = True
            comp_mask = env.const(comp, torch.bool)
    if operation == "add":
        new = sub_default[None] + sample
    elif operation == "scale":
        new = sub_default[None] * sample
    else:  # abs
        new = sample
    if comp_mask is not None:
        new = torch.where(comp_mask, new, sub_default[None])
    m = env_mask.reshape((E,) + (1,) * sub_default.ndim)
    cur.index_copy_(1, ids, torch.where(m, new.to(cur.dtype), cur[:, ids]))


def _expanded(env, field: str):
    """The Model field's (num_envs, ...) tensor, or None when it is
    shared."""
    cur = getattr(env.sim.model, field)
    shared = env.sim.get_default_field(field)
    return cur if cur.dim() == shared.dim() + 1 else None


def randomize_pd_gains(
    env,
    env_mask,
    stiffness_scale: tuple | None = None,
    damping_scale: tuple | None = None,
    asset_cfg: SceneEntityCfg = _DEFAULT,
    distribution: str = "uniform",
):
    """Scale every actuator group's PD gains from their defaults
    (mjlab_tpu/envs/mdp/events.py:327-393): per group a stiffness and a
    damping draw of (num_envs, joints), whatever its type; a builtin
    position group writes the per-env actuator_gainprm and biasprm (kp;
    -kp, -kd; RuntimeError when they are not expanded), an ideal PD group
    (DC and learned too) its state's gains; other groups (delayed, XML)
    keep theirs. As in the JAX package, a learned group's state has no
    gains here (an AttributeError)."""
    from mjlab_tpu_torch.actuator.builtin import BuiltinPositionActuator
    from mjlab_tpu_torch.actuator.pd import IdealPdActuator

    entity = env.scene[asset_cfg.name]
    E = env.num_envs
    st = entity.state
    for i, act in enumerate(entity.actuators):
        nj = len(act.joint_names)
        s_scale = (_rand(env.rng, distribution, *stiffness_scale, (E, nj))
                   if stiffness_scale else None)
        d_scale = (_rand(env.rng, distribution, *damping_scale, (E, nj))
                   if damping_scale else None)
        if isinstance(act, BuiltinPositionActuator):
            gain = _expanded(env, "actuator_gainprm")
            bias = _expanded(env, "actuator_biasprm")
            if gain is None or bias is None:
                raise RuntimeError(
                    "actuator_gainprm/biasprm not env-expanded; set "
                    "domain_randomization=True with field='actuator_gainprm'")
            cid = act.ctrl_ids
            kp0 = env.sim.get_default_field("actuator_gainprm")[cid, 0]
            kd0 = -env.sim.get_default_field("actuator_biasprm")[cid, 2]
            kp = kp0[None] * (s_scale if s_scale is not None else 1.0)
            kd = kd0[None] * (d_scale if d_scale is not None else 1.0)
            m = env_mask[:, None]
            gain[:, cid, 0] = torch.where(m, kp, gain[:, cid, 0]).to(gain.dtype)
            bias[:, cid, 1] = torch.where(m, -kp, bias[:, cid, 1]).to(bias.dtype)
            bias[:, cid, 2] = torch.where(m, -kd, bias[:, cid, 2]).to(bias.dtype)
        elif isinstance(act, IdealPdActuator):
            pstate = st.actuator_states[str(i)]
            kp = pstate.default_stiffness[None] * (s_scale if s_scale is not None else 1.0)
            kd = pstate.default_damping[None] * (d_scale if d_scale is not None else 1.0)
            IdealPdActuator.set_gains(pstate, env_mask, stiffness=kp, damping=kd)


def randomize_effort_limits(
    env,
    env_mask,
    scale: tuple = (1.0, 1.0),
    asset_cfg: SceneEntityCfg = _DEFAULT,
    distribution: str = "uniform",
):
    """Scale every actuator group's effort limit from its default
    (mjlab_tpu/envs/mdp/events.py:396-436): an ideal PD group (DC and
    learned too) its state's limit, one draw of (num_envs, joints); any
    other group the per-env actuator_forcerange, one draw of (num_envs,
    actuators), or nothing and no draw when the field is not expanded (a
    silent no-op, as in the JAX package)."""
    from mjlab_tpu_torch.actuator.pd import IdealPdActuator

    entity = env.scene[asset_cfg.name]
    E = env.num_envs
    st = entity.state
    for i, act in enumerate(entity.actuators):
        if not isinstance(act, IdealPdActuator):
            fr = _expanded(env, "actuator_forcerange")
            if fr is None:
                continue
            cid = act.ctrl_ids
            s = _rand(env.rng, distribution, *scale, (E, len(cid)))
            new = env.sim.get_default_field("actuator_forcerange")[cid][None] * s[..., None]
            m = env_mask[:, None, None]
            fr[:, cid] = torch.where(m, new, fr[:, cid]).to(fr.dtype)
            continue
        pstate = st.actuator_states[str(i)]
        s = _rand(env.rng, distribution, *scale, (E, len(act.joint_names)))
        IdealPdActuator.set_effort_limit(pstate, env_mask, pstate.default_effort_limit[None] * s)


def sync_actuator_delays(
    env,
    env_mask,
    min_lag: int,
    max_lag: int,
    asset_cfg: SceneEntityCfg = _DEFAULT,
):
    """The same lag range for every delayed actuator group of the entity
    (mjlab_tpu/envs/mdp/events.py:460-479; every env, whatever the
    mask)."""
    from mjlab_tpu_torch.actuator.delayed import DelayedActuator

    entity = env.scene[asset_cfg.name]
    st = entity.state
    for i, act in enumerate(entity.actuators):
        if isinstance(act, DelayedActuator):
            DelayedActuator.set_lags(st.actuator_states[str(i)], min_lag, max_lag)
