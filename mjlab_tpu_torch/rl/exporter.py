"""Deployment ONNX export of a trained policy.

PyTorch counterpart of mjlab_tpu/rl/exporter.py: the same graph (the
empirical obs normaliser fused in front of the actor MLP, without the +-10
clip that training applies, as the JAX package writes it) through the
in-repo ONNX writer (rl/onnx_proto.py), with the reference's metadata keys
as metadata_props. The metadata comes from the port's Model (names, gains,
transmissions), so no MuJoCo is needed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mjlab_tpu_torch.rl import onnx_proto as op

_ACT_ONNX = {
    "elu": ("Elu", {"alpha": 1.0}),
    "relu": ("Relu", {}),
    "tanh": ("Tanh", {}),
    "sigmoid": ("Sigmoid", {}),
}


def _dense_layers(seq: torch.nn.Sequential) -> list[tuple[np.ndarray, np.ndarray]]:
    """(kernel (in, out), bias) of each Linear, float32 numpy."""
    return [(lin.weight.detach().cpu().numpy().T, lin.bias.detach().cpu().numpy())
            for lin in seq if isinstance(lin, torch.nn.Linear)]


def export_policy_as_onnx(ppo, path: str, metadata: dict | None = None) -> None:
    """Write <path> with graph: obs -> (obs - mean) / std -> actor MLP ->
    action, for the learner ``ppo`` (rl/ppo.py PPO)."""
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
        inits.append(op.tensor("obs_mean", mean))
        inits.append(op.tensor("obs_std", std))
        nodes.append(op.Node("Sub", [cur, "obs_mean"], ["obs_centered"]))
        nodes.append(op.Node("Div", ["obs_centered", "obs_std"], ["obs_norm"]))
        cur = "obs_norm"

    n = len(layers)
    for i, (kernel, bias) in enumerate(layers):
        wname, bname = f"w{i}", f"b{i}"
        inits.append(op.tensor(wname, kernel))
        inits.append(op.tensor(bname, bias))
        out = "action" if i == n - 1 else f"h{i}"
        gemm_out = out if i == n - 1 else f"z{i}"
        nodes.append(op.Node("Gemm", [cur, wname, bname], [gemm_out],
                             attrs={"alpha": 1.0, "beta": 1.0, "transB": 0}))
        if i < n - 1:
            nodes.append(op.Node(act_name, [gemm_out], [out], attrs=act_attrs))
        cur = out

    g = op.graph(
        nodes,
        name="policy",
        inputs=[op.value_info("obs", ["batch", obs_dim])],
        outputs=[op.value_info("action", ["batch", layers[-1][0].shape[1]])],
        initializers=inits,
    )
    meta = {k: _to_meta_str(v) for k, v in (metadata or {}).items()}
    with open(path, "wb") as f:
        f.write(op.model(g, metadata=meta))


def _to_meta_str(v) -> str:
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)


def host_model(env):
    """The env's Model in float64 on the CPU: from the scene's model file,
    else converted from the MjModel the scene compiled (the Simulation
    holds the Model at the env's dtype)."""
    from mjlab_tpu_torch.phys.model import load_model, put_model

    path = env.cfg.scene.model_file
    if path is not None:
        return load_model(Path(path), dtype=torch.float64, device="cpu")[0]
    return put_model(env.sim.mj_model, dtype=torch.float64, nconmax=env.sim.cfg.nconmax,
                     device="cpu")


def get_base_metadata(env, run_path: str = "") -> dict:
    """Deployment metadata (reference rl/exporter_utils.py:23-64): joint
    names, gains and defaults in the robot's joint order, the obs and
    command wiring, the action scale; joint names, gains and transmissions
    from the port's Model."""
    robot = env.scene["robot"]
    m = host_model(env)
    trnid = np.asarray(m.actuator_trnid)
    joint_name_to_ctrl = {}
    for a in range(m.nu):
        jname = m.joint_names[int(trnid[a, 0])] or ""
        joint_name_to_ctrl[jname.split("/")[-1]] = a

    ctrl_ids = [joint_name_to_ctrl[j] for j in robot.joint_names if j in joint_name_to_ctrl]
    stiffness = m.actuator_gainprm.numpy()[ctrl_ids, 0]
    damping = -m.actuator_biasprm.numpy()[ctrl_ids, 2]
    action_term = env.action_manager.get_term("joint_pos")
    scale = np.asarray(torch.as_tensor(action_term.scale).cpu())
    if scale.ndim > 1:
        scale = scale[0]
    return {
        "run_path": run_path,
        "joint_names": list(robot.joint_names),
        "joint_stiffness": stiffness.tolist(),
        "joint_damping": damping.tolist(),
        "default_joint_pos": robot.data.default_joint_pos[0].cpu().numpy().tolist(),
        "command_names": list(env.command_manager.active_terms),
        "observation_names": list(env.observation_manager.active_terms["policy"]),
        "action_scale": scale.tolist() if scale.ndim else float(scale),
    }
