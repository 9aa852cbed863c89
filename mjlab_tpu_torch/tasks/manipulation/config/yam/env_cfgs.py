"""I2RT YAM lift-cube configuration, with its play variant.

PyTorch counterpart of mjlab_tpu/tasks/manipulation/config/yam/
env_cfgs.py. The scene loads its Model from yam_lift_cube.npz
(physics.py), so that it builds without MuJoCo; the cube entity is
physics.py's.
"""

from __future__ import annotations

from mjlab_tpu_torch.asset_zoo.robots.i2rt_yam.yam_constants import (
    YAM_ACTION_SCALE,
    get_yam_robot_cfg,
)
from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.tasks.manipulation.config.yam.physics import (
    SAVED_MODEL,
    cube_entity_cfg,
)
from mjlab_tpu_torch.tasks.manipulation.lift_cube_env_cfg import make_lift_cube_env_cfg


def yam_lift_cube_env_cfg(play: bool = False) -> ManagerBasedRlEnvCfg:
    cfg = make_lift_cube_env_cfg()

    cfg.scene.entities = {"robot": get_yam_robot_cfg(), "cube": cube_entity_cfg()}
    cfg.scene.model_file = SAVED_MODEL

    cfg.actions["joint_pos"].scale = YAM_ACTION_SCALE

    for group in ("policy", "critic"):
        cfg.observations[group].terms["ee_to_cube"].params[
            "asset_cfg"].site_names = ("grasp_site",)
    cfg.rewards["lift"].params["asset_cfg"].site_names = ("grasp_site",)

    fingertip_geoms = (r"[lr]f_down(6|7|8|9|10|11)_collision",)
    for ev in ("fingertip_friction_slide", "fingertip_friction_spin",
               "fingertip_friction_roll"):
        cfg.events[ev].params["asset_cfg"].geom_names = fingertip_geoms

    for sensor in cfg.scene.sensors:
        if sensor.name == "ee_ground_collision":
            sensor.primary.pattern = "link_6"

    if play:
        cfg.episode_length_s = int(1e9)
        cfg.observations["policy"].enable_corruption = False

    return cfg
