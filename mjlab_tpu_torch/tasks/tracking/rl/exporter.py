"""Motion-embedded deployment ONNX export of a tracking policy.

PyTorch counterpart of mjlab_tpu/tasks/tracking/rl/exporter.py: the graph
takes (obs, time_step) and returns the action and the reference motion's
frame at that time step. The whole motion is baked into the graph as
initializers and gathered at the clamped int64 index, so deployment needs
no side file. Written through the in-repo ONNX writer (rl/onnx_proto.py).
"""

from __future__ import annotations

import numpy as np

from mjlab_tpu_torch.rl import onnx_proto as op
from mjlab_tpu_torch.rl.exporter import _ACT_ONNX, _dense_layers, _to_meta_str

_MOTION_FIELDS = (
    "joint_pos", "joint_vel", "body_pos_w", "body_quat_w", "body_lin_vel_w",
    "body_ang_vel_w",
)


def export_motion_policy_as_onnx(env, ppo, path: str, metadata: dict | None = None) -> None:
    """Write <path>: obs -> (obs - mean) / std -> actor MLP -> actions, and
    time_step -> the motion command's frame (joint positions and
    velocities, the tracked bodies' poses and velocities), for the learner
    ``ppo`` (rl/ppo.py PPO) and the env's "motion" command."""
    motion = env.command_manager.get_term("motion").motion
    layers = _dense_layers(ppo.ac.actor)
    obs_dim = layers[0][0].shape[0]
    policy = ppo.cfg.policy
    act_name, act_attrs = _ACT_ONNX[policy.activation]

    nodes = []
    inits = []
    cur = "obs"
    if policy.actor_obs_normalization:
        mean = ppo.actor_norm.mean.detach().cpu().numpy()
        std = np.sqrt(ppo.actor_norm.var.detach().cpu().numpy() + 1e-8)
        inits += [op.tensor("obs_mean", mean), op.tensor("obs_std", std)]
        nodes.append(op.Node("Sub", [cur, "obs_mean"], ["obs_centered"]))
        nodes.append(op.Node("Div", ["obs_centered", "obs_std"], ["obs_norm"]))
        cur = "obs_norm"

    n = len(layers)
    for i, (kernel, bias) in enumerate(layers):
        inits += [op.tensor(f"w{i}", kernel), op.tensor(f"b{i}", bias)]
        gemm_out = "actions" if i == n - 1 else f"z{i}"
        nodes.append(op.Node("Gemm", [cur, f"w{i}", f"b{i}"], [gemm_out],
                             attrs={"alpha": 1.0, "beta": 1.0, "transB": 0}))
        if i < n - 1:
            nodes.append(op.Node(act_name, [gemm_out], [f"h{i}"], attrs=act_attrs))
            cur = f"h{i}"

    # the motion lookup: the float time step cast to int64, clamped to the
    # last frame, squeezed; one gather per motion array
    T = motion.time_step_total
    nodes.append(op.Node("Cast", ["time_step"], ["ts_i64"], attrs={"to": 7}))
    inits.append(op.tensor("ts_max", np.asarray([T - 1], np.int64)))
    nodes.append(op.Node("Min", ["ts_i64", "ts_max"], ["ts_clamped"]))
    nodes.append(op.Node("Squeeze", ["ts_clamped"], ["ts"], attrs={"axes": [1]}))

    outputs = [op.value_info("actions", ["batch", layers[-1][0].shape[1]])]
    for name in _MOTION_FIELDS:
        arr = getattr(motion, name).detach().cpu().numpy()
        inits.append(op.tensor(f"motion_{name}", arr))
        nodes.append(op.Node("Gather", [f"motion_{name}", "ts"], [name], attrs={"axis": 0}))
        outputs.append(op.value_info(name, ["batch"] + list(arr.shape[1:])))

    g = op.graph(
        nodes,
        name="motion_policy",
        inputs=[op.value_info("obs", ["batch", obs_dim]),
                op.value_info("time_step", ["batch", 1])],
        outputs=outputs,
        initializers=inits,
    )
    meta = {k: _to_meta_str(v) for k, v in (metadata or {}).items()}
    with open(path, "wb") as f:
        f.write(op.model(g, metadata=meta))
