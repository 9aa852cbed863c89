"""The port's explicit actuator library (mjlab_tpu_torch/actuator/{pd,dc,
delayed,learned,xml}.py) against the JAX package's (mjlab_tpu/actuator/),
on the CPU.

Each case builds the same group in both packages (6 envs, 4 joints),
feeds both the same seeded commands (numpy) over several physics steps and
compares what compute returns and the group's state; the JAX draws (the
delay buffers' phases, candidate lags and holds, eager calls) are
recorded and played back to the port (torch_port_common.JaxDraws,
ReplayRng). Tolerances: PD and DC relative 1e-6; delayed: the lags
exactly, the values relative 1e-6; learned relative 1e-5 (a TorchScript
MLP made in tmp_path from a seeded nn.Sequential; the port runs its
weights as tensor products); XML: the pass-through values exactly, and the
spec edit (an MJCF with position, motor and velocity actuators) compiles
to the same joint properties in both packages.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import JaxDraws, ReplayRng, rel_err

E, J, STEPS = 6, 4, 6
NAMES = [f"j{i}" for i in range(J)]
MASK = np.array([True, False, True, False, False, True])
PD = dict(stiffness=20.0, damping=1.5, effort_limit=6.0, armature=0.01)
DC = dict(PD, saturation_effort=8.0, velocity_limit=3.0)


def _cmds(seed: int, steps: int = STEPS):
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        c = {k: (s * rs.standard_normal((E, J))).astype(np.float32) for k, s in
             (("position_target", 1.0), ("velocity_target", 2.0), ("effort_target", 1.0),
              ("joint_pos", 1.0), ("joint_vel", 4.0))}
        out.append(c)
    return out


def _jcmd(c):
    from mjlab_tpu.actuator import ActuatorCmd

    return ActuatorCmd(**{k: jnp.asarray(v) for k, v in c.items()})


def _pcmd(c):
    from mjlab_tpu_torch.actuator.actuator import ActuatorCmd

    return ActuatorCmd(**{k: torch.as_tensor(v) for k, v in c.items()})


def _pair(kind: str, tmp_path=None, **over):
    """(JAX cfg, port cfg) of one group over NAMES."""
    import mjlab_tpu.actuator as ja
    from mjlab_tpu_torch.actuator import dc, delayed, learned, pd

    expr = (".*",)
    if kind == "pd":
        return (ja.IdealPdActuatorCfg(joint_names_expr=expr, **PD),
                pd.IdealPdActuatorCfg(joint_names_expr=expr, **PD))
    if kind == "dc":
        return (ja.DcMotorActuatorCfg(joint_names_expr=expr, **DC),
                dc.DcMotorActuatorCfg(joint_names_expr=expr, **DC))
    if kind.startswith("delayed"):
        targets = ("position", "velocity", "effort") if kind == "delayed_all" else "position"
        dp = dict(delay_target=targets, min_lag=0, max_lag=2, hold_prob=0.3,
                  update_period=2, per_env_phase=True)
        dp.update(over)
        jb, pb = _pair("dc")
        return (ja.DelayedActuatorCfg(joint_names_expr=expr, base_cfg=jb, **dp),
                delayed.DelayedActuatorCfg(joint_names_expr=expr, base_cfg=pb, **dp))
    assert kind == "learned"
    path = str(tmp_path / "mlp.pt")
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ELU(), torch.nn.Linear(16, 16),
                              torch.nn.ELU(), torch.nn.Linear(16, 1))
    torch.jit.script(net).save(path)
    lp = dict(DC, network_file=path, pos_scale=2.0, vel_scale=0.5, torque_scale=3.0,
              history_length=3)
    return (ja.LearnedMlpActuatorCfg(joint_names_expr=expr, **lp),
            learned.LearnedMlpActuatorCfg(joint_names_expr=expr, **lp))


def _build(kind, tmp_path=None, **over):
    """(JAX actuator, its state, port actuator, its state), the JAX
    initialize's draws played back to the port's."""
    import jax

    jc, pc = _pair(kind, tmp_path, **over)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ja_, pa = jc.build(None, list(range(J)), NAMES), pc.build(list(range(J)), NAMES)
    with JaxDraws() as draws:
        js = ja_.initialize(E, jax.random.PRNGKey(3))
    rng = ReplayRng(draws)
    ps = pa.initialize(E, "cpu", rng)
    assert rng.done()
    return ja_, js, pa, ps


def _step(ja_, js, pa, ps, c):
    """One compute in both packages on command c: (JAX state, JAX out,
    port out); the JAX draws played back."""
    with JaxDraws() as draws:
        js, jout = ja_.compute(js, _jcmd(c))
    rng = ReplayRng(draws)
    pout = pa.compute(ps, _pcmd(c), rng)
    assert rng.done()
    return js, np.asarray(jout), pout.numpy()


def _reset(ja_, js, pa, ps):
    import jax

    with JaxDraws() as draws:
        js = ja_.reset(js, jnp.asarray(MASK), jax.random.PRNGKey(5))
    rng = ReplayRng(draws)
    pa.reset(ps, torch.as_tensor(MASK), rng)
    assert rng.done()
    return js


def _pd_state_equal(jps, pps):
    for f in ("stiffness", "damping", "effort_limit", "default_stiffness", "default_damping",
              "default_effort_limit"):
        np.testing.assert_array_equal(np.asarray(getattr(jps, f)), getattr(pps, f).numpy(), f)


def _set_pd(cls_j, cls_p, js, ps, case, rs):
    """The DR helpers on a masked set of envs, in both packages."""
    m = jnp.asarray(MASK)
    pm = torch.as_tensor(MASK)
    if case == "set_gains":
        kp = rs.uniform(10, 30, (E, J)).astype(np.float32)
        kd = rs.uniform(0.5, 2, (E, J)).astype(np.float32)
        js = cls_j.set_gains(js, m, stiffness=jnp.asarray(kp), damping=jnp.asarray(kd))
        cls_p.set_gains(ps, pm, stiffness=torch.as_tensor(kp), damping=torch.as_tensor(kd))
    else:
        lim = rs.uniform(1, 8, (E, J)).astype(np.float32)
        js = cls_j.set_effort_limit(js, m, jnp.asarray(lim))
        cls_p.set_effort_limit(ps, pm, torch.as_tensor(lim))
    return js


@pytest.mark.parametrize("kind", ["pd", "dc"])
@pytest.mark.parametrize("case", ["compute", "set_gains", "set_effort_limit", "reset"])
def test_pd_and_dc_match_jax(kind, case):
    """compute over STEPS commands (the DC envelope moves some torques off
    the clipped PD law), after the DR helper or a masked reset."""
    from mjlab_tpu.actuator import IdealPdActuator as JPd
    from mjlab_tpu_torch.actuator.pd import IdealPdActuator as PPd

    ja_, js, pa, ps = _build(kind)
    _pd_state_equal(js, ps)
    rs = np.random.default_rng(1)
    if case in ("set_gains", "set_effort_limit"):
        js = _set_pd(JPd, PPd, js, ps, case, rs)
    elif case == "reset":
        js = _reset(ja_, js, pa, ps)
    _pd_state_equal(js, ps)
    enveloped = 0
    for c in _cmds(2):
        js, jo, po = _step(ja_, js, pa, ps, c)
        assert rel_err(jo, po) < 1e-6
        lim = np.asarray(js.effort_limit)
        pd_tau = np.clip(np.asarray(js.stiffness) * (c["position_target"] - c["joint_pos"])
                         + np.asarray(js.damping) * (c["velocity_target"] - c["joint_vel"])
                         + c["effort_target"], -lim, lim)
        enveloped += int((np.abs(po - pd_tau) > 1e-5).sum())
    # the DC envelope moves some torques off the clipped PD law, PD none
    assert (enveloped > 0) == (kind == "dc")


@pytest.mark.parametrize("kind", ["delayed", "delayed_all"])
@pytest.mark.parametrize("case", ["compute", "reset", "set_lags", "set_lags_past_capacity",
                                  "init"])
def test_delayed_matches_jax(kind, case):
    """The delayed DC group: lags equal exactly (the JAX draws played
    back), every buffer's state, and the delayed torques at 1e-6 relative;
    per_env_phase with update_period 2 (the phases drawn at initialize),
    hold 0.3; a masked reset resamples the masked envs' lags; set_lags
    (the sync_actuator_delays helper) moves the range, past the buffer's
    capacity too (not clipped, as in the JAX package: the read clamps to
    the history held)."""
    from mjlab_tpu.actuator import DelayedActuator as JD
    from mjlab_tpu_torch.actuator.delayed import DelayedActuator as PD_

    ja_, js, pa, ps = _build(kind)

    def same_buffers():
        for t, pb in ps.buffers.items():
            jb = js.buffers[t]
            for f in ("lag", "step", "phase"):
                np.testing.assert_array_equal(np.asarray(getattr(jb, f)), getattr(pb, f).numpy())
            np.testing.assert_array_equal(np.broadcast_to(np.asarray(jb.min_lag), (E,)),
                                          pb.min_lag.numpy())
            np.testing.assert_array_equal(np.broadcast_to(np.asarray(jb.max_lag), (E,)),
                                          pb.max_lag.numpy())
            np.testing.assert_array_equal(np.asarray(jb.hist.num_pushes),
                                          pb.hist.num_pushes.numpy())
            assert rel_err(np.asarray(jb.hist.buf), pb.hist.buf.numpy()) < 1e-6

    same_buffers()
    if case == "init":
        assert len(set(ps.buffers["position"].phase.tolist())) == 2  # both phases drawn
        return
    cmds = _cmds(4, 10)
    lags = set()
    for i, c in enumerate(cmds):
        if i == 4 and case == "reset":
            js = _reset(ja_, js, pa, ps)
        if i == 4 and case.startswith("set_lags"):
            hi = 5 if case == "set_lags_past_capacity" else 1
            js = JD.set_lags(js, 1, hi)
            PD_.set_lags(ps, 1, hi)
        js, jo, po = _step(ja_, js, pa, ps, c)
        same_buffers()
        assert rel_err(jo, po) < 1e-6
        lags |= set(ps.buffers["position"].lag.tolist())
    assert len(lags) >= 2  # the lags moved


@pytest.mark.parametrize("case", ["compute", "reset", "activation_from_graph", "input_order"])
def test_learned_matches_jax(tmp_path, case):
    """The learned MLP group: torques relative 1e-5 over STEPS physics
    steps (the histories most recent first), a masked reset clearing the
    masked envs' histories, the activation read from the TorchScript graph
    (elu), and vel_pos input order."""
    ja_, js, pa, ps = _build("learned", tmp_path)
    if case == "activation_from_graph":
        assert ja_._act.__name__ == "elu" and pa._act.__name__ == "elu"
    if case == "input_order":
        ja_.cfg.input_order = pa.cfg.input_order = "vel_pos"
    for i, c in enumerate(_cmds(6)):
        if i == 3 and case == "reset":
            js = _reset(ja_, js, pa, ps)
            assert not ps.pos_err_hist[torch.as_tensor(MASK)].any()
        js, jo, po = _step(ja_, js, pa, ps, c)
        assert rel_err(jo, po) < 1e-5
        assert rel_err(np.asarray(js.pos_err_hist), ps.pos_err_hist.numpy()) < 1e-6
        assert rel_err(np.asarray(js.vel_hist), ps.vel_hist.numpy()) < 1e-6


XML = """
<mujoco>
  <worldbody>
    <body name="a"><joint name="j0" type="hinge"/><geom size="0.1"/>
      <body name="b" pos="0 0 0.3"><joint name="j1" type="hinge" range="-1 1"/><geom size="0.1"/>
        <body name="c" pos="0 0 0.3"><joint name="j2" type="slide"/><geom size="0.1"/></body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position name="j0" joint="j0" kp="10"/>
    <motor name="j1" joint="j1" ctrlrange="-2 2" ctrllimited="true"/>
    <velocity name="j2" joint="j2" kv="3"/>
  </actuator>
</mujoco>
"""


@pytest.mark.parametrize("target", ["position", "motor", "velocity"])
def test_xml_actuators_match_jax(target):
    """Each XML type passes its target through (equal to the JAX group's
    output) and its spec edit sets the joint's armature and frictionloss
    as the JAX one does (both compiled)."""
    import mujoco

    import mjlab_tpu.actuator as ja
    from mjlab_tpu_torch.actuator import xml as px

    name = {"position": "Position", "motor": "Motor", "velocity": "Velocity"}[target]
    joint = {"position": "j0", "motor": "j1", "velocity": "j2"}[target]
    kw = dict(joint_names_expr=(joint,), armature=0.02, frictionloss=0.3)
    jc = getattr(ja, f"Xml{name}ActuatorCfg")(**kw)
    pc = getattr(px, f"Xml{name}ActuatorCfg")(**kw)
    specs = [mujoco.MjSpec.from_string(XML) for _ in range(2)]
    jc.build(None, [0], [joint]).edit_spec(specs[0], [joint])
    pc.edit_spec(specs[1], [joint])
    models = [s.compile() for s in specs]
    for f in ("dof_armature", "dof_frictionloss", "actuator_gainprm", "actuator_biasprm"):
        np.testing.assert_array_equal(getattr(models[0], f), getattr(models[1], f), f)
    assert models[1].dof_armature[models[1].jnt_dofadr[mujoco.mj_name2id(
        models[1], mujoco.mjtObj.mjOBJ_JOINT, joint)]] == 0.02
    jgroup, pgroup = jc.build(None, [0], [joint]), pc.build([0], [joint])
    assert jgroup.is_passthrough and pgroup.is_passthrough
    c = {k: v[:, :1] for k, v in _cmds(7, 1)[0].items()}
    _, jo = jgroup.compute(None, _jcmd(c))
    np.testing.assert_array_equal(np.asarray(jo), pgroup.compute(None, _pcmd(c)).numpy())


def test_create_motor_actuator_matches_jax():
    """The host-only spec helper makes the JAX package's motor (gear,
    ctrl and force ranges, the joint's armature and frictionloss)."""
    import mujoco

    from mjlab_tpu.utils.spec import create_motor_actuator as jm
    from mjlab_tpu_torch.actuator.builtin import create_motor_actuator as pm_

    specs = [mujoco.MjSpec.from_string(XML.split("<actuator>")[0] + "</mujoco>")
             for _ in range(2)]
    for f, s in zip((jm, pm_), specs):
        f(s, "j1", effort_limit=7.0, gear=2.0, armature=0.1, frictionloss=0.2)
    a, b = (s.compile() for s in specs)
    for f in ("actuator_gear", "actuator_ctrlrange", "actuator_forcerange",
              "actuator_ctrllimited", "actuator_forcelimited", "actuator_gaintype",
              "actuator_biastype", "dof_armature", "dof_frictionloss"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
