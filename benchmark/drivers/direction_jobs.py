"""Direction-finding jobs back to back, as StyleMC's users run them.

One prompt a job: `stylemc_torch.train.find_direction.find_direction`,
called as `cli/find_direction.py` calls it (precompute included, its
callback every 10 steps copying the direction to the host and writing
nothing). Several prompts a job (`prompts_per_job` > 1): one
`DirectionEngine` built in set-up, its `optimize_batch` called back to
back, each call with a fresh seeded set of prompts. Prompt pairs come from
the traffic file's list in a seeded order; the 129 styles from seeded z
through the program's mapping (truncation as in the README's
generate_w) and w_to_s.

The window closes at the first 10-step callback after `--seconds`; the
end-to-end metric is its wall time over the prompt-steps completed. With
--trace 1 the profiler covers 10 steady steps of the first job (from the
callback at `trace_from`), taken again on the next 10 where it missed
events. The first job runs to its end even past the close (untimed): the
losses of its first `check_steps` steps, from the loss history it
returns, are what the reference checks.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..core import models as core_models, precision, timing
from ..core.tokenizer import FrozenTokenizer, token_ids
from ..reference import stylemc
from . import program

B1, B2 = "upsample2x_kernel", "downsample2x_kernel"


class _Close(Exception):
    """Raised from a callback to end the job in flight at the window's
    close."""


def _fdc(job: Dict[str, Any], pair, layout):
    from stylemc_torch.train.find_direction import FindDirectionConfig

    return FindDirectionConfig(
        text_prompt=pair[0], negative_text_prompt=pair[1],
        arcface_layout=layout,
        resolution=job["resolution"], batch_size=job["batch_size"],
        learning_rate=job["learning_rate"], n_epochs=job["n_epochs"],
        identity_loss_coef=job["identity_loss_coef"],
        l2_reg_coef=job["l2_reg_coef"], clip_loss_coef=job["clip_loss_coef"],
        clip_type=job["clip_type"], seed=job["fd_seed"])


def _pairs(ctx, count: int) -> List[List[str]]:
    """`count` prompt pairs in the seed's order (cycling the list)."""
    pool = ctx.traffic["prompts"]
    rng = program.seeded_rng(ctx.seed, "prompts")
    order = np.concatenate([rng.permutation(len(pool))
                            for _ in range(count // len(pool) + 1)])
    return [pool[i] for i in order[:count]]


def setup(ctx) -> Dict[str, Any]:
    from stylemc_torch.models.stylegan2.generator import mapping, w_to_s

    t = ctx.traffic
    job = t["job"]
    models = core_models.make_models(ctx.config, ctx.seed, ctx.device)
    cfg = program.generator_config(ctx.config["generator"])
    z = program.zs(ctx.seed, job["n_items"], cfg.z_dim, ctx.device)
    with torch.no_grad():
        styles = w_to_s(models["generator"], cfg, mapping(
            models["generator"], cfg, z,
            truncation_psi=ctx.config["truncation_psi"]))
    jobs = 64
    state = {"models": models, "cfg": cfg, "z": z, "styles": styles,
             "clip": program.clip_models(models),
             "tokenizer": FrozenTokenizer(),
             "pairs": _pairs(ctx, jobs * t["prompts_per_job"]),
             # a direction a user resumes each job from (the CLI's --resume)
             "resume": None if "resume_scale" not in t else [
                 d.cpu().numpy() for d in program.directions(
                     ctx.seed, [f"resume {k}" for k in range(jobs)],
                     t["resume_scale"], ctx.device).values()]}
    if t["prompts_per_job"] > 1:
        from stylemc_torch.train.find_direction import DirectionEngine

        state["engine"] = DirectionEngine(
            models["generator"], cfg, styles, state["clip"],
            models["arcface"][0],
            _fdc(job, state["pairs"][0], models["arcface"][1]),
            tokenizer=state["tokenizer"])
    # warm-up: the first ten steps of one job, every shape the window runs
    _run_job(ctx, state, t["warmup_pairs"][:t["prompts_per_job"]], None,
             lambda it: True)
    return state


def _run_job(ctx, state, pairs, resume, on_callback):
    """One job on `pairs`, resumed from `resume` (a direction [1, 26, 512]
    or None); on_callback(step) after each 10-step callback's
    copy of the direction to the host; True ends the job (→ None), else
    the job runs to its end (→ its loss history [steps, prompts])."""
    job = ctx.traffic["job"]
    models = state["models"]

    def stop_if(it):
        if on_callback(it):
            raise _Close

    with contextlib.suppress(_Close):
        if "engine" not in state:
            from stylemc_torch.train.find_direction import find_direction

            _, info = find_direction(
                models["generator"], state["cfg"], state["styles"],
                state["clip"], models["arcface"][0],
                _fdc(job, pairs[0], models["arcface"][1]),
                tokenizer=state["tokenizer"], resume_direction=resume,
                callback=lambda it, loss, aux, lr, grad_norm, direction:
                stop_if(it))
            return torch.tensor(info["history"])[:, None]
        _, info = state["engine"].optimize_batch(
            [p[0] for p in pairs], [p[1] for p in pairs],
            callback=lambda it, losses, aux, lr, dirs: stop_if(it))
        return torch.as_tensor(np.asarray(info["history"])).T
    return None


def window(ctx, state) -> Dict[str, Any]:
    t = ctx.traffic
    per = t["prompts_per_job"]
    job = t["job"]
    total = -(-job["n_items"] // job["batch_size"]) * job["n_epochs"]
    rec: Dict[str, Any] = {"jobs": 0, "outputs": None}
    traced: Dict[str, Any] = {}
    close: Dict[str, float] = {}
    done = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while not close:
        k = rec["jobs"]
        job_pairs = state["pairs"][k * per:(k + 1) * per]
        resume = None if state["resume"] is None else state["resume"][k]
        first = k == 0

        def on_callback(it):
            if first and ctx.trace:
                _trace_hook(traced, it, t["trace_from"], per, rec)
            if not close and time.perf_counter() >= deadline:
                close.update(t=time.perf_counter(), steps=done + it)
            # the first job runs on to its end, past the close, untimed:
            # its first steps' losses are what the reference checks
            return bool(close) and not first

        history = _run_job(ctx, state, job_pairs, resume, on_callback)
        rec["jobs"] += 1
        if first:
            rec["outputs"] = {"losses": history[:t["check_steps"]].float(),
                              "pairs": job_pairs, "resume": resume}
        done += total
        if not close and time.perf_counter() >= deadline:
            close.update(t=time.perf_counter(), steps=done)
    rec["window_s"] = close["t"] - t0
    rec["prompt_steps"] = close["steps"] * per
    rec["attempted"], rec["failed"] = rec["prompt_steps"], 0
    return rec


def _trace_hook(traced, it, start_at, per, rec) -> None:
    """Start the profiler at the callback of step `start_at` and stop it
    ten steps later; a trace that missed events, or whose B1 and B2 counts
    are not six a step, is taken again over the next ten, twice at most."""
    tr = traced.get("trace")
    if tr is None:
        if it == start_at:
            tr = traced["trace"] = timing.Trace()
            tr.start()
            traced["from"] = it
        return
    if "trace" in rec or it != traced["from"] + 10:
        return
    tr.stop()
    ok = tr.valid and tr.kernel_seconds(B1)[1] == 60 and \
        tr.kernel_seconds(B2)[1] == 60
    if ok or it >= start_at + 30:
        rec.update(trace=tr, trace_prompt_steps=10 * per)
    else:
        tr = traced["trace"] = timing.Trace()
        tr.start()
        traced["from"] = it


def release(ctx, state) -> Dict[str, Any]:
    return {"models": state.pop("models"), "z": state.pop("z")}


FAULTS = ("unchanged", "half_batch")


def reference(ctx, inputs, outputs, tf32: bool = False, fault=None
              ) -> torch.Tensor:
    """The reference's losses [check_steps, prompts] on the first job's
    prompt pairs and start, at TF32 or with a planted fault
    (reference.stylemc.follow) where asked."""
    pairs = outputs["pairs"]
    g = ctx.config["generator"]
    dev = inputs["z"].device
    with precision.tf32(tf32):
        with torch.no_grad():
            styles = stylemc.styles_of(inputs["models"], g, inputs["z"],
                                       ctx.config["truncation_psi"])
        tokens = {"pos": stylemc.tokens_to(token_ids([p[0] for p in pairs]),
                                           dev),
                  "neg": stylemc.tokens_to(token_ids([p[1] for p in pairs]),
                                           dev)}
        out = stylemc.follow(inputs["models"], g, styles, tokens,
                             ctx.traffic["job"], ctx.traffic["check_steps"],
                             ctx.config["until_k"], fault=fault,
                             start=None if outputs["resume"] is None else
                             torch.as_tensor(outputs["resume"][:, list(
                                 stylemc.TRAINABLE)]))
    return out["losses"].cpu()


def control(ctx, inputs, outputs, fault=None) -> Dict[str, Any]:
    """The reference in the program's place: at TF32 (the control), or at
    float32 with one of FAULTS planted."""
    return {"losses": reference(ctx, inputs, outputs, tf32=fault is None,
                                fault=fault),
            "pairs": outputs["pairs"], "resume": outputs["resume"]}


def check(ctx, inputs, outputs) -> Dict[str, float]:
    """loss1, loss2: the worst relative gap over the prompts of the first
    job's loss at its first and at its second step. The first reads the
    forward path at the start both sides share; the second the first
    step's gradient and update."""
    ref = reference(ctx, inputs, outputs)
    gaps = ((outputs["losses"] - ref).abs() / ref.abs()).max(dim=1).values
    print(f"loss gaps by step {gaps.tolist()}; program "
          f"{outputs['losses'].tolist()}, reference {ref.tolist()}",
          file=sys.stderr)
    return {f"loss{i + 1}": float(gap) for i, gap in enumerate(gaps)}
