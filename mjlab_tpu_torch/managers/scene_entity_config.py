"""SceneEntityCfg: a regex-bearing reference to scene elements, resolved
once at manager construction into index tensors on the env's device.

PyTorch counterpart of mjlab_tpu/managers/scene_entity_config.py. Names
resolve through the port's Entity.find_* (entity/entity.py), against the
names of the port's Model; the ids become a LongTensor on the entity's
device (a term's gather then needs no host copy), or slice(None) when
every name matched in order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class SceneEntityCfg:
    name: str = "robot"
    joint_names: tuple[str, ...] | str | None = None
    joint_ids: object = slice(None)
    body_names: tuple[str, ...] | str | None = None
    body_ids: object = slice(None)
    geom_names: tuple[str, ...] | str | None = None
    geom_ids: object = slice(None)
    site_names: tuple[str, ...] | str | None = None
    site_ids: object = slice(None)
    actuator_names: tuple[str, ...] | str | None = None
    actuator_ids: object = slice(None)
    preserve_order: bool = False

    def resolve(self, scene) -> None:
        entity = scene[self.name]
        device = entity.indexing.body_ids.device
        for kind in ("joint", "body", "geom", "site", "actuator"):
            names = getattr(self, f"{kind}_names")
            if names is None:
                continue
            if isinstance(names, str):
                names = (names,)
            plural = "bodies" if kind == "body" else f"{kind}s"
            finder = getattr(entity, f"find_{plural}")
            ids, matched = finder(list(names), preserve_order=self.preserve_order)
            all_names = getattr(
                entity, {"actuator": "actuator_joint_names"}.get(kind, f"{kind}_names"))
            setattr(self, f"{kind}_names", tuple(matched))
            if ids == list(range(len(all_names))):
                setattr(self, f"{kind}_ids", slice(None))
            else:
                setattr(self, f"{kind}_ids",
                        torch.as_tensor(ids, dtype=torch.long, device=device))
