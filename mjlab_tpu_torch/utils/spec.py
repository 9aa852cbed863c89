"""MjSpec helpers (host side, run once when a scene is built).

PyTorch-package counterpart of mjlab_tpu/utils/spec.py's
``auto_wrap_fixed_base_mocap``: an entity without a free joint gets a
mocap body as its root, so that its base pose is a per-env input
(Data.mocap_pos / mocap_quat) rather than a constant of the model.
"""

from __future__ import annotations

from typing import Callable

import mujoco
import numpy as np


def auto_wrap_fixed_base_mocap(
    spec_fn: Callable[[], mujoco.MjSpec],
) -> Callable[[], mujoco.MjSpec]:
    """``spec_fn`` with a fixed-base entity made mocap-driven: a single
    jointless root body is marked mocap; an articulated fixed-base entity
    is attached under a new mocap body "mocap_base", its keyframes moved to
    the wrapper. A floating-base entity is returned as it is."""

    def wrapped() -> mujoco.MjSpec:
        spec = spec_fn()
        if any(j.type == mujoco.mjtJoint.mjJNT_FREE for j in spec.joints):
            return spec
        bodies = list(spec.worldbody.bodies)
        if bodies and bodies[0].mocap:
            return spec
        if len(bodies) == 1 and not spec.joints:
            bodies[0].mocap = True
            return spec
        keyframes = [
            (np.array(k.qpos), np.array(k.ctrl), k.name) for k in spec.keys
        ]
        for k in list(spec.keys):
            spec.delete(k)
        wrapper = mujoco.MjSpec()
        mocap_body = wrapper.worldbody.add_body(name="mocap_base", mocap=True)
        wrapper.attach(child=spec, prefix="", frame=mocap_body.add_frame())
        for qpos, ctrl, name in keyframes:
            wrapper.add_key(name=name, qpos=qpos, ctrl=ctrl)
        return wrapper

    return wrapped
