"""Train CLI (reference src/mjlab/scripts/train.py).

PyTorch counterpart of mjlab_tpu/scripts/train.py, with its override
syntax: dotted ``--env.`` / ``--agent.`` flags onto the nested config
dataclasses (scalars, booleans, tuples and lists, enums by name or value,
Optional fields, ``ClassName(...)`` variants) and ``TASK --help``, which
lists every field.

Usage (the card by default; --device cpu runs the plain PyTorch versions):

  python -m mjlab_tpu_torch.scripts.train Mjlab-Velocity-Flat-Unitree-G1 \
      --env.scene.num-envs 4096 --max-iterations 1000
  python -m mjlab_tpu_torch.scripts.train Mjlab-Lift-Cube-Yam --num-envs 4096
  python -m mjlab_tpu_torch.scripts.train Mjlab-Tracking-Flat-Unitree-G1 \
      --motion-file evidence/tracking_r4/motion.npz --num-envs 4096
  python -m mjlab_tpu_torch.scripts.train Mjlab-Jump-Flat-Unitree-G1 --num-envs 4096
  python -m mjlab_tpu_torch.scripts.train Mjlab-Jumping-Flat-Unitree-G1 --num-envs 4096

The tasks it trains are the port's registered ones, all nine of the JAX
package: the four velocity tasks
(Mjlab-Velocity-{Flat,Rough}-Unitree-{G1,Go1}), the YAM arm's cube lift
(Mjlab-Lift-Cube-Yam), the G1 motion tracking tasks
(Mjlab-Tracking-Flat-Unitree-G1 and its -No-State-Estimation variant),
whose motion comes from --motion-file (or the MJLAB_TPU_MOTION_FILE
environment variable the task config reads), and the G1 jump tasks
(Mjlab-Jump-Flat-Unitree-G1: one jump from a crouch, dt 0.002 and
decimation 2; Mjlab-Jumping-Flat-Unitree-G1: repeated commanded hops).
The lift-cube and jump tasks register no runner class: they train with
OnPolicyRunner.

Checkpoints are rsl-rl ``model_<it>.pt`` files in the run's log dir (with
``<run>.onnx`` beside them for the velocity tasks, and the motion-embedded
``<run>.onnx`` for the tracking tasks), the configs are dumped to
``params/{env,agent}.yaml``. --resume loads the newest run's newest
checkpoint (the agent config's load_run and load_checkpoint regexes),
--checkpoint an explicit one. Not ported, and each raises
NotImplementedError: --distributed (data-parallel training),
--enable-nan-guard (the NaN guard), and the tracking flag --registry-name
(it fetches the motion from the W&B registry over the network).
"""

from __future__ import annotations

import argparse
import datetime
import os


def _variant_candidates(tgt, leaf, cur):
    """Dataclass types selectable for field `leaf` of `tgt`: the declared
    union members (typing annotation) plus all their subclasses, plus the
    current value's own class hierarchy — the pool the ClassName(...)
    override syntax resolves against (tyro's union-of-dataclass
    subcommand surface, reference scripts/train.py:240-245)."""
    import dataclasses
    import typing

    def subs(t):
        out = [t]
        for s in getattr(t, "__subclasses__", lambda: [])():
            out.extend(subs(s))
        return out

    cands = []
    if dataclasses.is_dataclass(tgt):
        try:
            hints = typing.get_type_hints(type(tgt))
            ann = hints.get(leaf)
        except Exception:  # noqa: BLE001
            ann = None
        if ann is not None:
            for t in typing.get_args(ann) or (ann,):
                if dataclasses.is_dataclass(t):
                    cands.extend(subs(t))
    if cur is not None and dataclasses.is_dataclass(type(cur)):
        for base in type(cur).__mro__:
            if dataclasses.is_dataclass(base):
                cands.extend(subs(base))
    # dedupe, keep order
    seen, out = set(), []
    for t in cands:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def _parse_variant(value: str, candidates):
    """Parse 'ClassName(a=1, b=(2, 3))' into an instance of the matching
    candidate dataclass; returns None when value is not that shape."""
    import ast

    try:
        tree = ast.parse(value.strip(), mode="eval")
    except SyntaxError:
        return None
    call = tree.body
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
            and not call.args):
        return None
    name = call.func.id
    cls = next((t for t in candidates if t.__name__ == name), None)
    if cls is None:
        raise ValueError(
            f"unknown cfg variant '{name}'; choices: "
            f"{sorted({t.__name__ for t in candidates})}"
        )
    kwargs = {
        kw.arg: ast.literal_eval(kw.value) for kw in call.keywords
    }
    return cls(**kwargs)


def _parse_override_value(cur, value: str, candidates=()):
    """Parse a CLI override string against the current field value.

    Covers the nested-cfg value kinds the reference's tyro surface
    handles (reference scripts/train.py:224-248): scalars, booleans,
    enums (by NAME or value), tuples/lists (python literal syntax or
    bare comma-separated), Optional[...] fields (current value None:
    literal-parsed, 'none' -> None), and union-of-dataclass variant
    selection via 'ClassName(field=value, ...)'."""
    import ast
    import enum as _enum

    if candidates and "(" in value:
        v = _parse_variant(value, candidates)
        if v is not None:
            return v
    if isinstance(cur, _enum.Enum):
        ecls = type(cur)
        try:
            return ecls[value]
        except KeyError:
            try:
                return ecls(ast.literal_eval(value))
            except (ValueError, SyntaxError, KeyError):
                return ecls(value)
    if isinstance(cur, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if value.lower() in ("none", "null"):
        return None
    try:
        lit = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lit = value
    if cur is None:
        return lit
    if isinstance(cur, (tuple, list)):
        if isinstance(lit, str):
            lit = tuple(
                ast.literal_eval(x.strip()) for x in lit.split(",") if x.strip()
            )
        elif not isinstance(lit, (tuple, list)):
            lit = (lit,)
        return type(cur)(lit)
    if isinstance(lit, str):
        return lit if isinstance(cur, str) else type(cur)(value)
    return type(cur)(lit)


def _apply_overrides(obj, overrides: list[str]):
    """Apply --a.b.c=value style overrides onto nested dataclasses/dicts."""
    for ov in overrides:
        if "=" in ov:
            path, value = ov.split("=", 1)
        else:
            raise ValueError(f"override '{ov}' must be key=value")
        path = path.lstrip("-").replace("-", "_")
        parts = path.split(".")
        tgt = obj
        for p in parts[:-1]:
            tgt = tgt[p] if isinstance(tgt, dict) else getattr(tgt, p)
        leaf = parts[-1]
        if isinstance(tgt, dict):
            if leaf not in tgt:
                raise AttributeError(
                    f"override path '{path}': no key '{leaf}'"
                )
            cands = _variant_candidates(tgt, leaf, tgt[leaf])
            tgt[leaf] = _parse_override_value(tgt[leaf], value, cands)
        else:
            cur = getattr(tgt, leaf)  # AttributeError on bad paths
            cands = _variant_candidates(tgt, leaf, cur)
            setattr(tgt, leaf, _parse_override_value(cur, value, cands))


def run_train(
    task: str,
    num_envs: int | None = None,
    max_iterations: int | None = None,
    seed: int | None = None,
    log_dir: str | None = None,
    env_overrides: list[str] | None = None,
    agent_overrides: list[str] | None = None,
    distributed: bool = False,
    resume: bool = False,
    checkpoint: str | None = None,
    enable_nan_guard: bool = False,
    registry_name: str | None = None,
    motion_file: str | None = None,
    device: str = "cuda",
):
    if distributed:
        raise NotImplementedError(
            "--distributed: data-parallel training (torch.distributed with NCCL) is not "
            "ported")
    if registry_name is not None:
        raise NotImplementedError(
            "--registry-name is not ported: fetching a motion from the W&B registry needs "
            "the network and wandb; pass a local --motion-file")

    import mjlab_tpu_torch.tasks as tasks
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.rl import OnPolicyRunner, RslRlVecEnvWrapper
    from mjlab_tpu_torch.utils.os import dump_yaml, get_checkpoint_path

    env_cfg = tasks.load_env_cfg(task)
    agent_cfg = tasks.load_rl_cfg(task)
    runner_cls = tasks.load_runner_cls(task) or OnPolicyRunner

    if num_envs:
        env_cfg.scene.num_envs = num_envs
    if seed is not None:
        env_cfg.seed = seed
        agent_cfg.seed = seed
    if max_iterations:
        agent_cfg.max_iterations = max_iterations
    if enable_nan_guard:
        from mjlab_tpu_torch.utils.nan_guard import NanGuardCfg

        env_cfg.sim.nan_guard = NanGuardCfg(enabled=True)
    _apply_overrides(env_cfg, env_overrides or [])
    _apply_overrides(agent_cfg, agent_overrides or [])
    if resume:
        agent_cfg.resume = True
    # tracking tasks: the motion from a local file (reference
    # scripts/train.py:68-92)
    if motion_file is not None and isinstance(env_cfg.commands, dict) \
            and "motion" in env_cfg.commands:
        env_cfg.commands["motion"].motion_file = motion_file

    if log_dir is None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        log_dir = os.path.join("logs", agent_cfg.experiment_name, stamp)
    os.makedirs(log_dir, exist_ok=True)
    dump_yaml(os.path.join(log_dir, "params", "env.yaml"), env_cfg)
    dump_yaml(os.path.join(log_dir, "params", "agent.yaml"), agent_cfg)

    env = ManagerBasedRlEnv(env_cfg, device=device)
    wrapped = RslRlVecEnvWrapper(env, clip_actions=agent_cfg.clip_actions)
    runner = runner_cls(wrapped, agent_cfg, log_dir=log_dir, device=device)

    # resume: an explicit checkpoint, else the newest run and checkpoint by
    # the config's regexes (reference scripts/train.py:111-128)
    if agent_cfg.resume or checkpoint:
        ckpt = checkpoint
        if ckpt is None:
            log_root = os.path.join("logs", agent_cfg.experiment_name)
            ckpt = get_checkpoint_path(log_root, agent_cfg.load_run, agent_cfg.load_checkpoint)
        print(f"[train] resuming from {ckpt}")
        runner.load(ckpt)

    runner.learn(agent_cfg.max_iterations)
    return runner


def enumerate_cfg_fields(obj, prefix="", depth=0, max_depth=6):
    """Yield (dotted-flag, type-name, default-repr) rows for every nested
    cfg field — the tyro-style auto-generated per-field help surface
    (reference scripts/train.py:236-248 `train TASK --help`)."""
    import dataclasses

    if depth > max_depth:
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [
            (f.name, getattr(obj, f.name, None))
            for f in dataclasses.fields(obj)
        ]
    elif isinstance(obj, dict):
        items = list(obj.items())
    else:
        return
    for name, val in items:
        path = f"{prefix}.{name}" if prefix else name
        import dataclasses as _dc

        if (_dc.is_dataclass(val) and not isinstance(val, type)) or (
            isinstance(val, dict)
            and val
            and any(_dc.is_dataclass(v) for v in val.values())
        ):
            yield (path, type(val).__name__, None)
            yield from enumerate_cfg_fields(val, path, depth + 1, max_depth)
        else:
            rep = repr(val)
            if len(rep) > 48:
                rep = rep[:45] + "..."
            yield (path, type(val).__name__, rep)


def _print_cfg_help(task: str):
    from mjlab_tpu_torch.tasks.registry import load_env_cfg, load_rl_cfg

    print(f"\nConfig overrides for {task} "
          "(--env.PATH VALUE / --agent.PATH VALUE):")
    for root, cfg in (
        ("env", load_env_cfg(task)), ("agent", load_rl_cfg(task)),
    ):
        print(f"\n[{root}]")
        for path, tname, default in enumerate_cfg_fields(cfg):
            flag = f"--{root}.{path.replace('_', '-')}"
            if default is None and tname not in ("NoneType",):
                print(f"  {flag}  ({tname})")
            else:
                print(f"  {flag}  ({tname}) = {default}")


def main():
    from mjlab_tpu_torch.tasks import list_tasks

    parser = argparse.ArgumentParser(description="Train a task of the PyTorch port")
    parser.add_argument("task", help="a registered task: " + ", ".join(list_tasks()))
    parser.add_argument("--num-envs", type=int, default=None)
    parser.add_argument("--max-iterations", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; cpu runs the plain PyTorch versions)",
    )
    parser.add_argument("--distributed", action="store_true", help="not ported")
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the latest run/checkpoint (agent cfg regexes)",
    )
    parser.add_argument(
        "--checkpoint", default=None, help="explicit checkpoint to load"
    )
    parser.add_argument(
        "--enable-nan-guard", action="store_true",
        help="not ported",
    )
    parser.add_argument(
        "--registry-name", default=None,
        help="tracking tasks: a W&B motion registry artifact (not ported: needs the network)",
    )
    parser.add_argument(
        "--motion-file", default=None,
        help="tracking tasks: a local motion npz",
    )
    parser.add_argument(
        "--env", action="append", default=[], help="env cfg override key=value"
    )
    parser.add_argument(
        "--agent", action="append", default=[], help="agent cfg override key=value"
    )
    # `train TASK --help` additionally enumerates every nested cfg field
    # (the tyro-generated per-field help of the reference CLI)
    import sys as _sys

    argv = _sys.argv[1:]
    if ("-h" in argv or "--help" in argv) and argv and not argv[0].startswith("-"):
        parser.print_help()
        _print_cfg_help(argv[0])
        raise SystemExit(0)
    args, unknown = parser.parse_known_args()
    # tyro-style dotted overrides (reference CLI surface,
    # reference scripts/train.py:236-245): --env.scene.num-envs 4096 or
    # --agent.algorithm.gamma=0.99 map onto the nested cfg dataclasses
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        for prefix, dest in (("--env.", args.env), ("--agent.", args.agent)):
            if tok.startswith(prefix):
                kv = tok[len(prefix):]
                if "=" not in kv:
                    if i + 1 >= len(unknown):
                        parser.error(f"missing value for {tok}")
                    kv = f"{kv}={unknown[i + 1]}"
                    i += 1
                dest.append(kv)
                break
        else:
            parser.error(f"unrecognized argument: {tok}")
        i += 1
    run_train(
        args.task,
        num_envs=args.num_envs,
        max_iterations=args.max_iterations,
        seed=args.seed,
        log_dir=args.log_dir,
        env_overrides=args.env,
        agent_overrides=args.agent,
        distributed=args.distributed,
        resume=args.resume,
        checkpoint=args.checkpoint,
        enable_nan_guard=args.enable_nan_guard,
        registry_name=args.registry_name,
        motion_file=args.motion_file,
        device=args.device,
    )


if __name__ == "__main__":
    main()
