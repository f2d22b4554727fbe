#!/usr/bin/env python3
"""mini-ActivityNet accuracy run of the PyTorch/CUDA port: the AdaFocus
recipe end to end through the port's CLIs, on one GPU, with the results the
JAX package's harness records (``benchmarks/miniact_harness.py``, whose
numbers are in ``benchmarks/miniact_results.json``).

Phases, in order (each resumable: a training run is skipped when its
done-marker exists, an evaluation when its key is in the results):

  dataset    ``python -m adafocus_torch.data.miniact`` (50 classes, 24 + 8
             videos a class, 16 frames, 256^2 canvas), if absent.
  base       stages 0 -> 1 -> 2 -> 3 at the flagship operating point (16
             frames, 224^2 glance, 96^2 patches, 49 anchors), B=32,
             ``model.remat=true``, the dataset in a device cache, each
             stage warm-started from the one before.
  baselines  the stage-3 weights under the learned, random, center and
             oracle patch policies (``run.anytime_eval=true``), then the
             ``oversample`` and ``full_res`` multi-view evaluations.
  int8       int8 post-training quantization of the stage-3 weights, with
             and without quantized heads.
  sthhard    the sth-sth family at the spatially demanding point (glance
             96^2, 8 + 12 frames, continuous per-division PPO with the
             BatchNorm encoder, action_std 0.25): a shared stage 1 from the
             base stage 0, then stages 2 and 3 and the four-policy bracket
             for every seed.
  frontier   AdaFocus+ with the straight-through selector at K=4 frames,
             stages 1 and 2 from the base stage 1 for every seed.
  s0seeds    stage 0 alone at every seed of ``--s0-seeds``, validated every
             epoch, in ``--s0-dtype``: the spread of stage 0 over seeds
             (not part of the JAX harness's recipe, and not run unless named).

Every training and evaluation runs as a subprocess of the port's CLI
(``python -m adafocus_torch.cli.train`` / ``cli.evaluate``) with the
overrides of the JAX harness; this script only sequences them. It writes
the harness's result keys (a seed-replicated row: mean and population
standard deviation over the seeds) to ``--results``, with each
subprocess's wall time under ``runs`` and the card under ``device``, and
prints each row beside the JAX package's value with its tolerance (the
full profile only).

    python3 port_miniact.py                          # all phases, on the GPU
    python3 port_miniact.py --phases dataset,base    # some of them
    python3 port_miniact.py --tiny --platform cpu    # the tiny profile, on the CPU
    python3 port_miniact.py --base-seed 1009 --phases dataset,base,baselines,int8
                                                     # the base's rows again at another seed
    python3 port_miniact.py --phases dataset,s0seeds --s0-seeds 1007,1009
                                                     # stage 0's curve at each seed
    python3 port_miniact.py --merge other_results.json
                                                     # another call's new keys

It runs on the GPU, holding the device lock (``utils/device_lock.py``),
unless ``--platform cpu`` is given; without a GPU and without that flag it
exits non-zero before running anything.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("dataset", "base", "baselines", "int8", "sthhard", "frontier")
EXTRA_PHASES = ("s0seeds",)   # run only when named in --phases
S0_SEEDS = (1007, 1009, 1013, 1019, 1021, 1031, 1033, 1039)
TAKEOFF = 0.5   # the validation top-1 that counts stage 0 as taken off
POLICIES = ("learned", "random", "center", "oracle")
BUDGET = 4    # the frontier's one point: the ST selector at K=4 frames
SEEDS = (1007, 1009, 1013)   # run.seed of the seed-replicated phases (sthhard, frontier)
REFERENCE = os.path.join(REPO, "benchmarks", "miniact_results.json")   # the JAX package's


def profiles(tiny: bool, dataset: str):
    """(dataset generation argv, shared CLI overrides, epochs a stage, sth-sth
    overrides, the hard point's glance size): the JAX harness's profiles
    (``benchmarks/miniact_harness.py:62-118``)."""
    if tiny:
        gen = ["--classes", "4", "--train-per-class", "6", "--val-per-class", "3",
               "--frames", "4", "--canvas", "64"]
        base = ["run.dataset=miniact", f"run.data_root={dataset}",
                "model.num_classes=4", "model.num_frames=4", "model.image_size=32",
                "model.glance_size=16", "model.patch_size=16", "model.action_dim=4",
                "model.hidden_dim=16", "model.policy_hidden=16", "model.dtype=float32",
                "loader.batch_size=4", "loader.canvas_size=40", "loader.cache=host",
                "run.print_freq=100"]
        epochs = {"s0": 2, "s1": 2, "s2": 2, "s3": 1, "plus1": 1, "plus2": 1,
                  "sth1": 2, "sth2": 2, "sth3": 1}
        sth = ["model.num_frames=4", "model.num_frames_focuser=4", "model.video_div=2",
               "model.action_std=0.25", "model.policy_channels=8", "model.policy_bn=true"]
        return gen, base, epochs, sth, 8
    gen = ["--classes", "50", "--train-per-class", "24", "--val-per-class", "8",
           "--frames", "16", "--canvas", "256"]
    base = ["run.dataset=miniact", f"run.data_root={dataset}",
            "model.num_classes=50", "model.num_frames=16", "model.image_size=224",
            "model.glance_size=224", "model.patch_size=96", "model.action_dim=49",
            "model.remat=true", "loader.batch_size=32", "loader.canvas_size=256",
            "loader.cache=device", "run.print_freq=20", "run.eval_freq=5"]
    epochs = {"s0": 25, "s1": 20, "s2": 30, "s3": 10, "plus1": 8, "plus2": 8,
              "sth1": 20, "sth2": 25, "sth3": 10}
    sth = ["model.num_frames=8", "model.num_frames_focuser=12", "model.video_div=2",
           "model.action_std=0.25", "model.policy_channels=64", "model.policy_bn=true"]
    return gen, base, epochs, sth, 96


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def parse_final(out: str) -> dict:
    """The evaluate CLI's 'final: top1=.. top5=.. mAP=..' line."""
    m = re.findall(r"final:((?: \w+=[0-9.]+)+)", out)
    if not m:
        raise RuntimeError("no 'final:' line in the evaluation's output")
    return {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", m[-1])}


def parse_best(out: str) -> float:
    m = re.findall(r"done\. best acc ([0-9.]+)", out)
    return float(m[-1]) if m else float("nan")


def parse_curve(out: str) -> dict:
    """Every validation row of a training run's output, in order: top-1,
    top-5 and (where logged) mAP, each a list over the validations."""
    rows = re.findall(r"\* val: top1=([0-9.]+) top5=([0-9.]+)(?: mAP=([0-9.]+))?", out)
    curve = {"top1": [float(r[0]) for r in rows], "top5": [float(r[1]) for r in rows]}
    if rows and all(r[2] for r in rows):
        curve["mAP"] = [float(r[2]) for r in rows]
    return curve


def parse_anytime(out: str):
    m = re.findall(r"anytime mAP per timestep: ([0-9. ]+)", out)
    return [float(x) for x in m[-1].split()] if m else None


class Runner:
    def __init__(self, args):
        self.args = args
        self.gen, self.base, self.epochs, self.sth, self.hard_glance = \
            profiles(args.tiny, args.dataset)
        if args.platform == "cpu":
            self.base = ["run.platform=cpu"] + self.base
        # the base chain at another seed: its checkpoints and keys take the seed
        self.key_sfx = self.ck_sfx = self.base_tag = ""
        if args.base_seed is not None:
            self.base = self.base + [f"run.seed={args.base_seed}"]
            self.key_sfx, self.ck_sfx = f"@{args.base_seed}", f"_{args.base_seed}"
            self.base_tag = f"@base{args.base_seed}"
        self.work = args.workdir
        self.logs = args.logdir or os.path.join(self.work, "logs")
        os.makedirs(self.work, exist_ok=True)
        self.results = {}
        if os.path.exists(args.results):
            with open(args.results) as f:
                self.results = json.load(f)
        self.results.setdefault("runs", {})

    def save(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.args.results)), exist_ok=True)
        tmp = f"{self.args.results}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.results, f, indent=1)
        os.replace(tmp, self.args.results)

    def ck(self, name: str) -> str:
        return os.path.join(self.work, f"ck_{name}")

    def run(self, module: str, argv, name: str, env=None) -> str:
        """``python -m module argv`` from the repository root, with ``env``
        added to the environment; its output goes to ``<logdir>/<name>.log``
        and its wall time to ``results['runs']``. Raises on a non-zero
        exit."""
        cmd = [sys.executable, "-m", module] + list(argv)
        print(f"  $ python -m {module} {' '.join(argv)}", flush=True)
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              env={**os.environ, **(env or {})})
        seconds = time.time() - t0
        out = proc.stdout + proc.stderr
        os.makedirs(self.logs, exist_ok=True)
        log = os.path.join(self.logs, name.replace("/", "_") + ".log")
        with open(log, "w") as f:
            f.write(out)
        if proc.returncode != 0:
            print(out[-4000:], flush=True)
            raise RuntimeError(f"{module} failed (rc {proc.returncode}); log: {log}")
        self.results["runs"][name] = {"module": module, "seconds": round(seconds, 1)}
        self.save()
        print(f"    done in {seconds:.1f} s", flush=True)
        return out

    def train(self, name: str, overrides) -> float:
        """One training run (skipped when its done-marker exists); its best
        top-1. Only ``model_best.pt``, which warm starts and evaluations
        read, is kept: ``checkpoint.pt`` serves a resume of the run alone."""
        ck = self.ck(name)
        marker = os.path.join(ck, ".done")
        if not os.path.exists(marker):
            out = self.run("adafocus_torch.cli.train",
                           list(overrides) + [f"run.ckpt_dir={ck}"], f"train_{name}")
            with open(marker, "w") as f:
                f.write(str(parse_best(out)))
            if os.path.exists(os.path.join(ck, "model_best.pt")):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(os.path.join(ck, "checkpoint.pt"))
        with open(marker) as f:
            return float(f.read().strip() or "nan")

    def evaluate(self, key: str, ckpt: str, overrides) -> dict:
        if key not in self.results:
            out = self.run("adafocus_torch.cli.evaluate",
                           list(overrides) + [f"run.resume={self.ck(ckpt)}",
                                              f"run.ckpt_dir={self.ck(ckpt)}"], f"eval_{key}")
            res = parse_final(out)
            anytime = parse_anytime(out)
            if anytime:
                res["anytime_mAP"] = anytime
            self.results[key] = res
            self.save()
        return self.results[key]

    def aggregate(self, key: str, seed_keys) -> dict:
        """Mean and population standard deviation over per-seed rows."""
        present = [k for k in seed_keys if k in self.results]
        rows = [self.results[k] for k in present]
        agg = {}
        for field in ("mAP", "top1", "top5"):
            xs = [r[field] for r in rows if field in r]
            if xs:
                agg[field] = statistics.mean(xs)
                agg[field + "_std"] = statistics.pstdev(xs) if len(xs) > 1 else 0.0
        agg["n_seeds"] = len(rows)
        agg["per_seed"] = {k.rsplit("@", 1)[-1]: {f: r[f] for f in ("mAP", "top1") if f in r}
                           for k, r in zip(present, rows)}
        self.results[key] = agg
        self.save()
        return agg

    # -- phases ---------------------------------------------------------------

    def phase_dataset(self):
        if not os.path.exists(os.path.join(self.args.dataset, "gt.npz")):
            self.run("adafocus_torch.data.miniact", ["--root", self.args.dataset] + self.gen,
                     "dataset")

    def phase_base(self):
        b, e = self.base, self.epochs
        prev = []
        for stage in range(4):
            name = f"s{stage}"
            self.results[f"train/{name}{self.key_sfx}"] = self.train(
                name + self.ck_sfx, b + [f"run.stage={stage}", f"run.epochs={e[name]}"] + prev)
            prev = [f"run.warm_start={self.ck(name + self.ck_sfx)}"]
        self.save()

    def phase_baselines(self):
        s3 = "s3" + self.ck_sfx
        for mode in POLICIES:
            ov = self.base + [f"run.eval_policy={mode}", "run.anytime_eval=true"]
            if mode == "oracle":
                ov.append(f"run.oracle_gt={os.path.join(self.args.dataset, 'gt.npz')}")
            self.evaluate(f"eval/{mode}{self.key_sfx}", s3, ov)
        for crops in ("oversample", "full_res"):
            self.evaluate(f"eval/{crops}{self.key_sfx}", s3,
                          self.base + [f"augment.eval_crops={crops}"])

    def phase_int8(self):
        q8 = ["run.quantize=int8", "run.quantize_batches=4"]
        s3 = "s3" + self.ck_sfx
        self.evaluate(f"eval/int8{self.key_sfx}", s3, self.base + q8)
        self.evaluate(f"eval/int8_heads{self.key_sfx}", s3,
                      self.base + q8 + ["run.quantize_heads=true"])

    def phase_sthhard(self):
        """``benchmarks/miniact_harness.py`` phase_sthhard on its
        ``_sth_hard_base``: stage 1 shared (random patches, so it does not
        depend on the seed), stages 2 and 3 and the bracket for every seed.
        From the base at ``--base-seed`` N, its keys start ``sthhard@baseN/``."""
        b = [o for o in self.base
             if not o.startswith(("model.num_frames", "model.glance_size="))]
        b += self.sth + [f"model.glance_size={self.hard_glance}", "run.family=sthsth",
                         "model.tsm=true", "model.classifier=consensus",
                         "model.continuous_policy=true"]
        e, p, c = self.epochs, "sthhard" + self.base_tag, self.ck_sfx
        self.results[f"{p}/s1"] = self.train(
            "sh1" + c, b + ["run.stage=1", f"run.epochs={e['sth1']}",
                            f"run.warm_start={self.ck('s0' + c)}"])
        for seed in SEEDS:
            sb = b + [f"run.seed={seed}"]
            self.results[f"{p}/s2@{seed}"] = self.train(
                f"sh2_{seed}{c}", sb + ["run.stage=2", f"run.epochs={e['sth2']}",
                                        f"run.warm_start={self.ck('sh1' + c)}"])
            self.results[f"{p}/s3@{seed}"] = self.train(
                f"sh3_{seed}{c}", sb + ["run.stage=3", f"run.epochs={e['sth3']}",
                                        f"run.warm_start={self.ck(f'sh2_{seed}{c}')}"])
            for mode in POLICIES:
                ov = sb + [f"run.eval_policy={mode}"]
                if mode == "oracle":
                    ov.append(f"run.oracle_gt={os.path.join(self.args.dataset, 'gt.npz')}")
                self.evaluate(f"{p}/{mode}@{seed}", f"sh3_{seed}{c}", ov)
        for mode in POLICIES:
            self.aggregate(f"{p}/{mode}", [f"{p}/{mode}@{s}" for s in SEEDS])
        rec = []
        for seed in SEEDS:
            ln, rn, oc = (self.results.get(f"{p}/{m}@{seed}", {})
                          for m in ("learned", "random", "oracle"))
            if all("mAP" in d for d in (ln, rn, oc)) and oc["mAP"] > rn["mAP"]:
                rec.append((ln["mAP"] - rn["mAP"]) / (oc["mAP"] - rn["mAP"]))
        if rec:
            self.results[f"{p}/oracle_gap_recovery"] = {"per_seed": rec,
                                                         "mean": sum(rec) / len(rec)}

    def phase_frontier(self):
        """From the base at ``--base-seed`` N, its keys start ``frontier@baseN/``."""
        b, e, p = self.base, self.epochs, "frontier" + self.base_tag
        keys = []
        for seed in SEEDS:
            name = f"plusstK{BUDGET}_{seed}{self.ck_sfx}"
            sb = b + [f"model.frame_budget={BUDGET}", f"run.seed={seed}"]
            self.train(name + "_s1", sb + ["run.stage=1", f"run.epochs={e['plus1']}",
                                           f"run.warm_start={self.ck('s1' + self.ck_sfx)}"])
            self.train(name + "_s2", sb + ["run.stage=2", f"run.epochs={e['plus2']}",
                                           f"run.warm_start={self.ck(name + '_s1')}"])
            key = f"{p}/st_K{BUDGET}@{seed}"
            self.evaluate(key, name + "_s2", sb)
            keys.append(key)
        self.aggregate(f"{p}/st_K{BUDGET}", keys)

    def phase_s0seeds(self):
        """Stage 0 alone at each seed of ``--s0-seeds``, validated every epoch,
        ``model.dtype`` from ``--s0-dtype``. bfloat16 runs with
        ``model.remat=false`` (remat recomputes exactly: the same validation rows);
        float32 keeps remat on, its activations taking twice bfloat16's
        memory, and runs with ``NVIDIA_TF32_OVERRIDE=0``, so that cuDNN's
        convolutions do not round their inputs to TF32. Keys
        ``s0seeds/<dtype>@<seed>``: the best top-1, the first epoch (from 0)
        whose validation top-1 reaches ``TAKEOFF`` (None if none does), and
        the validation curve; ``s0seeds/<dtype>``: over the seeds, the best
        top-1's and the take-off epoch's mean and population standard
        deviation, each seed's take-off epoch, and how many never reach
        ``TAKEOFF``."""
        dtype = self.args.s0_dtype or ("float32" if self.args.tiny else "bfloat16")
        f32 = dtype == "float32"
        drop = ("model.remat=", "run.eval_freq=", "run.seed=", "model.dtype=")
        b = [o for o in self.base if not o.startswith(drop)]
        b += [f"model.dtype={dtype}", f"model.remat={'true' if f32 else 'false'}",
              "run.eval_freq=1", "run.stage=0", f"run.epochs={self.epochs['s0']}"]
        env = {"NVIDIA_TF32_OVERRIDE": "0"} if f32 else None
        for seed in self.args.s0_seeds:
            key = f"s0seeds/{dtype}@{seed}"
            if key in self.results:
                continue
            ck = self.ck(f"s0seed_{dtype}_{seed}")
            out = self.run("adafocus_torch.cli.train", b + [f"run.seed={seed}",
                                                           f"run.ckpt_dir={ck}"],
                           f"train_s0seed_{dtype}_{seed}", env)
            curve = parse_curve(out)
            first = next((e for e, v in enumerate(curve["top1"]) if v >= TAKEOFF), None)
            self.results[key] = {"best_top1": parse_best(out), "first_epoch_ge_0.5": first,
                                 "curve": curve}
            self.save()
            for name in ("checkpoint.pt", "model_best.pt"):   # nothing reads them
                with contextlib.suppress(FileNotFoundError):
                    os.remove(os.path.join(ck, name))
        s0_spread(self.results)
        self.save()


def s0_spread(results: dict) -> None:
    """``s0seeds/<dtype>`` of every dtype in ``results``, from its
    ``s0seeds/<dtype>@<seed>`` rows (``Runner.phase_s0seeds``)."""
    by_dtype = {}
    for k, v in results.items():
        if k.startswith("s0seeds/") and "@" in k:
            dtype, seed = k[len("s0seeds/"):].split("@")
            by_dtype.setdefault(dtype, {})[seed] = v
    for dtype, rows in by_dtype.items():
        best = [r["best_top1"] for r in rows.values()]
        first = {s: r["first_epoch_ge_0.5"] for s, r in sorted(rows.items())}
        took_off = [e for e in first.values() if e is not None]
        results[f"s0seeds/{dtype}"] = {
            "best_top1": statistics.mean(best), "best_top1_std": statistics.pstdev(best),
            "first_epoch_ge_0.5": statistics.mean(took_off) if took_off else None,
            "first_epoch_ge_0.5_std": statistics.pstdev(took_off) if took_off else None,
            "per_seed_first_epoch_ge_0.5": first,
            "n_never": len(first) - len(took_off), "n_seeds": len(best)}


def merge(results_path: str, other_path: str) -> None:
    """Adds to ``results_path`` the keys of ``other_path`` (the results of a
    run in another call) that it lacks, and their runs' seconds under
    ``runs``; changes no key it has, then recomputes the stage-0 spreads."""
    with open(results_path) as f:
        results = json.load(f)
    with open(other_path) as f:
        other = json.load(f)
    for k, v in other.items():
        if k not in results and k not in ("device", "phase_seconds"):
            results[k] = v
    runs = results.setdefault("runs", {})
    for k, v in other.get("runs", {}).items():
        runs.setdefault(k, v)
    s0_spread(results)
    with open(results_path, "w") as f:
        json.dump(results, f, indent=1)


# -- the comparison with the JAX package's results ------------------------------

def _values(d: dict, key: str, field=None, reruns: bool = True):
    """``key``'s value and, with ``reruns``, those of its reruns at other
    seeds (``key@<seed>``), in that order."""
    out = []
    for k in [key] + (sorted(k for k in d if k.startswith(key + "@")) if reruns else []):
        v = d.get(k)
        if field is not None:
            v = v.get(field) if isinstance(v, dict) else None
        if isinstance(v, (int, float)):
            out.append(v)
    return out


def compare(port: dict, ref: dict):
    """Rows (name, JAX, port, port - JAX, tolerance, within, seeds) of the
    accuracy bar: best top-1 of each base stage +-0.04; the bracket's mAP
    +-0.03 and top-1 +-0.04; the multi-view mAP +-0.03; int8's mAP change
    against the learned row +-0.02 (+-0.03 with quantized heads); the sth-sth
    hard point's means +-0.05; the frontier's mean mAP +-0.02. A base row
    rerun at other seeds (``--base-seed``) is compared as the mean over its
    runs; the sth-sth and frontier rows of a base at another seed
    (``sthhard@base<seed>``, ...) each get rows of their own. Rows whose key
    is missing on either side are left out."""
    rows = []

    def row(name, want, got, tol, n=None):
        if want and got:
            m = statistics.mean(got)
            rows.append((name, want[0], m, m - want[0], tol, abs(m - want[0]) <= tol,
                         n or len(got)))

    def seeds(key):
        return port.get(key, {}).get("n_seeds")

    for s in range(4):
        row(f"train/s{s} top-1", _values(ref, f"train/s{s}"), _values(port, f"train/s{s}"), 0.04)
    for mode in POLICIES:
        for field, name, tol in (("mAP", "mAP", 0.03), ("top1", "top-1", 0.04)):
            row(f"eval/{mode} {name}", _values(ref, f"eval/{mode}", field),
                _values(port, f"eval/{mode}", field), tol)
    for crops in ("oversample", "full_res"):
        row(f"eval/{crops} mAP", _values(ref, f"eval/{crops}", "mAP"),
            _values(port, f"eval/{crops}", "mAP"), 0.03)
    for key, tol in (("eval/int8", 0.02), ("eval/int8_heads", 0.03)):
        want, got = ([a - b for a, b in zip(_values(d, key, "mAP"),
                                            _values(d, "eval/learned", "mAP"))]
                     for d in (ref, port))
        row(f"{key} mAP - eval/learned mAP", want, got, tol)
    for phase, tol in (("sthhard", 0.05), ("frontier", 0.02)):
        names = [f"{phase}/{m}" for m in POLICIES] if phase == "sthhard" else \
            [f"{phase}/st_K{BUDGET}"]
        for prefix in [phase] + _bases(port, phase):
            for name in names:
                key = prefix + name[len(phase):]
                row(f"{key} mean mAP", _values(ref, name, "mAP", False),
                    _values(port, key, "mAP", False), tol, seeds(key))
    return rows


def _bases(port: dict, phase: str):
    """The ``<phase>@base<seed>`` prefixes of runs from a base at another seed."""
    return sorted({k.split("/")[0] for k in port if k.startswith(phase + "@base")})


def margins(port: dict):
    """Per seed of the sth-sth hard point (and of its runs from a base at
    another seed): learned mAP minus the larger of random's and center's (the
    bar: at least 0.10)."""
    out = {}
    for prefix in ["sthhard"] + _bases(port, "sthhard"):
        for seed in port.get(f"{prefix}/learned", {}).get("per_seed", {}):
            vals = [port.get(f"{prefix}/{m}@{seed}", {}).get("mAP")
                    for m in ("learned", "random", "center")]
            if None not in vals:
                out[f"{prefix} @{seed}"] = vals[0] - max(vals[1:])
    return out


def report(port: dict, ref_path: str) -> None:
    if not os.path.exists(ref_path):
        return
    with open(ref_path) as f:
        ref = json.load(f)
    lines = ["", "| row | JAX | port | port - JAX | tolerance | within | port runs |",
             "|---|---|---|---|---|---|---|"]
    for name, want, got, diff, tol, ok, n in compare(port, ref):
        lines.append(f"| {name} | {want:.4f} | {got:.4f} | {diff:+.4f} | {tol} | "
                     f"{'yes' if ok else 'NO'} | {n} |")
    for name, m in margins(port).items():
        lines.append(f"| {name} learned - max(random, center) | | {m:.4f} | | "
                     f">= 0.10 | {'yes' if m >= 0.10 else 'NO'} | 1 |")
    print("\n".join(lines), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default=os.path.join(REPO, ".data", "port_miniact"))
    ap.add_argument("--workdir", default=os.path.join(REPO, ".data", "port_miniact_work"))
    ap.add_argument("--logdir", default="", help="the runs' logs (default <workdir>/logs)")
    ap.add_argument("--results", default=os.path.join(REPO, "port_miniact_results.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX harness's tiny profile (tiny dataset and model, float32)")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--base-seed", type=int, default=None,
                    help="run the base at this run.seed: its checkpoints and keys take "
                         "the seed (train/s0@<seed>, eval/learned@<seed>, ...), and sthhard "
                         "and frontier start from it (keys sthhard@base<seed>/...)")
    ap.add_argument("--s0-seeds", default=",".join(map(str, S0_SEEDS)),
                    type=lambda v: [int(x) for x in v.split(",") if x.strip()],
                    help="the seeds of the s0seeds phase")
    ap.add_argument("--s0-dtype", default=None, choices=("bfloat16", "float32"),
                    help="model.dtype of the s0seeds phase (default bfloat16; float32 "
                         "with --tiny)")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--merge", default="", metavar="OTHER",
                    help="run nothing: add the keys of the results file OTHER that "
                         "--results lacks (a run in another call), then recompute the "
                         "stage-0 spreads")
    args = ap.parse_args(argv)
    if args.merge:
        merge(args.results, args.merge)
        return 0
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from "
                 f"{','.join(PHASES + EXTRA_PHASES)}")

    lock = contextlib.nullcontext()
    if args.platform == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("port_miniact: no CUDA device is visible; pass --platform cpu to run on "
                  "the CPU", file=sys.stderr)
            return 1
        from adafocus_torch.utils.device_lock import device_lock

        lock = device_lock(note="port_miniact")
    runner = Runner(args)
    runner.results["device"] = card() if args.platform == "cuda" else "cpu"
    with lock:
        for phase in phases:
            print(f"[{phase}{runner.key_sfx}]", flush=True)
            t0 = time.time()
            getattr(runner, f"phase_{phase}")()
            spent = runner.results.setdefault("phase_seconds", {})
            name = phase + runner.key_sfx
            spent[name] = round(spent.get(name, 0.0) + time.time() - t0, 1)
            runner.save()
    if not args.tiny:
        report(runner.results, REFERENCE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
