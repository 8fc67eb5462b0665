"""Training solver (orchestrator) of the PyTorch port.

Counterpart of ``iterated_learning_for_vlm_tpu/train/solver.py`` (reference
``example/clip_fdt/train_solver.py`` ``ClsSolver`` and
``example/clip/train_solver.py``): model -> optimizer -> data -> schedule ->
a step-driven loop with the FDT temperature decay, the iterated-learning
phases, the loss-crash detector, ``metrics.jsonl``, checkpoints and resume.

The step (``train/step.py``) runs eagerly and updates the model's
parameters in place; the loop feeds it batches on the solver's device, calls
the IL controller after each step and keeps each step's metrics as device
scalars, read to the host only at log boundaries (every 50 and every
``print_freq`` steps), so the loop adds no per-step device sync. Batches
come from webdataset shards (``data/pipeline.py:get_wds_dataset``: decode,
MOCOV2 augment, tokenize, context buckets) or from ``data/synthetic.py``, and
reach the device through ``prefetch_to_device``, which stages the next two
while the step runs.

The eval hooks (``evaluate``: SugarCREPE, ``imagenet_evaluate``: zero-shot
classification) score the model through a ``TorchEncoder`` as JAX's do.

Data parallel: in a process group (``parallel/mesh.py:init_data_parallel``,
one process per rank) the Solver trains the model wrapped in
``DistributedDataParallel`` with the global-batch InfoNCE, each rank on its
own rows (the loader's rank split; ``batch_size`` is a rank's), the ranks
agreeing on each step's context bucket (``context_buckets_sync``). Every
rank holds the same parameters after every step: the same initial draw,
averaged gradients, the same seeded IL resets. Only rank 0 writes the log
file, ``metrics.jsonl``, ``config.json`` and the checkpoints; every rank
restores. Without a group it is the one-device path.

Ported so far: the ``clip`` recipe (CLIP and CLIP-FDT), data parallel.
Tensor parallelism (ROADMAP.md Queue 1 item 5) and the other recipes and
their batch extras (item 6) raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..data.pipeline import (caption_lengths, get_wds_dataset, prefetch_to_device,
                             synced_bucket_batches)
from ..data.synthetic import SyntheticClipData
from ..data.tokenizer import get_tokenizer
from ..models import model_entry
from ..models.layers import init_module_tree
from ..parallel.mesh import barrier, data_rank_world, initialized, local_device
from ..utils.config import Config
from ..utils.logging import MetricsWriter, create_logger, get_logger
from ..utils.meters import AverageMeter
from ..utils.profiling import span
from .checkpoint import (find_last_checkpoint, load_checkpoint, modify_state,
                         restore_checkpoint, save_checkpoint, wait_for_saves)
from .il import ILController, ResetConfig
from .optim import adamw_init, build_wd_tree, trainable_mask_tree
from .schedule import scheduler_entry
from .step import make_eval_step, make_train_step
from .train_state import TrainState


def fdt_temperature(step: int, t_decay: Optional[Config], default: float) -> float:
    """Reference T-decay (train_solver.py:353-364): at every multiple of
    ``sd_T_decay_iter`` set ``T = org_t * w^(step/decay_iter)`` floored at
    ``sd_T_min``; constant ``org_t`` before the first boundary."""
    if not t_decay:
        return default
    m = step // int(t_decay["sd_T_decay_iter"])
    if m <= 0:
        return float(t_decay["org_t"])
    t = float(t_decay["org_t"]) * float(t_decay["sd_T_decay_w"]) ** m
    return max(t, float(t_decay["sd_T_min"]))


def _exp_dir(exp_name: str, reset_cfg) -> str:
    return (f"{exp_name}_Reset_{reset_cfg.get('enable', False)}"
            f"_steps_{reset_cfg.get('reset_steps', 0)}"
            f"_smooth_{reset_cfg.get('smooth_steps', 0)}")


class Solver:
    """Build and train a CLIP / CLIP-FDT model from a reference-schema config.

    ``device``: where the model, the state and the batches live; None means
    this rank's CUDA card (``parallel.mesh.local_device``, which raises where
    there is none). In a process group every rank builds its Solver with the
    same arguments."""

    def __init__(
        self,
        config: Config,
        output_path: str = "output",
        exp_name: str = "run",
        batch_size: Optional[int] = None,
        ckpt_path: Optional[str] = None,
        debug: bool = False,
        seed: int = 0,
        device=None,
    ):
        self.config = config
        self.debug = debug
        self.seed = seed
        self.device = local_device(device)
        self.rank, self.world_size = data_rank_world()
        if batch_size is not None:
            config.data.train.batch_size = batch_size

        # the run's files from rank 0 only (reference rank-0 logging,
        # train_solver.py:169-183; JAX solver.py:89-96); the others log to stderr
        is_main = self.rank == 0
        self._set_output(output_path, exp_name)
        create_logger(os.path.join(self.output_path, "log.txt") if is_main else None)
        self.logger = get_logger("solver")
        self.metrics_writer = MetricsWriter(os.path.join(self.output_path, "metrics.jsonl"),
                                            enabled=not debug and is_main)
        if is_main:
            config.dump_json(os.path.join(self.output_path, "config.json"))

        if int((config.get("parallel") or {}).get("model_parallel", 1) or 1) > 1:
            raise NotImplementedError(
                "parallel.model_parallel > 1 (tensor parallelism) is not ported to the PyTorch "
                "package (ROADMAP.md Queue 1 item 5, tensor parallelism)")
        self.is_fdt = "fdt" in config.model.type
        # method-recipe dispatch as in JAX: an explicit `recipe:` wins, else
        # inferred from model.type
        mtype = config.model.type
        self.recipe = config.get("recipe") or (
            "defilip" if "defilip" in mtype
            else "declip" if "declip" in mtype
            else "clip"
        )
        if self.recipe != "clip":
            raise NotImplementedError(
                f"recipe {self.recipe!r} is not ported to the PyTorch package; ported: 'clip' "
                f"(ROADMAP.md Queue 1 item 6, recipes)")
        self.lipreg_lambda = float(config.get("lipreg", 0.0) or 0.0)

        self._build_model()
        self._build_optimizer()
        # in a group the step runs through DDP; it broadcasts rank 0's
        # parameters once, here (every rank drew the same ones)
        self.train_model = (DistributedDataParallel(self.model, static_graph=True)
                            if initialized() else self.model)
        self._build_data()
        self._build_lr_scheduler()
        self._build_il()
        self._last_iter = 0
        if ckpt_path == "auto":
            # auto-resume from the newest checkpoint (reference legacy solver
            # ``find_last_checkpoint``, prototype/solver/clip_solver.py:179-189)
            ckpt_path = find_last_checkpoint(self.save_path)
        if ckpt_path:
            restore_checkpoint(ckpt_path, self.model, self.state)
            self._last_iter = self.state.step
            self.logger.info("restored checkpoint %s at step %d", ckpt_path, self._last_iter)
        elif config.get("saver", {}).get("pretrain"):
            # finetune from a pretrained checkpoint with selective drops
            # (reference saver.pretrain + modify_state, prototype/utils/misc.py:520-533)
            pcfg = config.saver.pretrain
            ckpt = modify_state(load_checkpoint(pcfg["path"]), self.model, self.state,
                                pcfg.get("ignore", {}))
            restore_checkpoint(ckpt, self.model, self.state)
            self._last_iter = self.state.step
            self.logger.info("loaded pretrain %s (ignore=%s), starting at step %d", pcfg["path"],
                             dict(pcfg.get("ignore", {})), self._last_iter)

    def _set_output(self, output_path: str, exp_name: str) -> None:
        self.output_path = os.path.join(output_path,
                                        _exp_dir(exp_name, self.config.get("reset", {}) or {}))
        self.save_path = os.path.join(self.output_path, "checkpoints")
        self.result_path = os.path.join(self.output_path, "results")
        for p in (self.output_path, self.save_path, self.result_path):
            os.makedirs(p, exist_ok=True)

    # -- builders ------------------------------------------------------------
    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _build_model(self):
        self.model = model_entry(self.config.model, self.device,
                                 generator=self._generator(self.seed))
        self.tokenizer = get_tokenizer()
        self.params = dict(self.model.named_parameters())
        n_params = sum(p.numel() for p in self.params.values())
        self.logger.info("model %s: %.2fM params", self.config.model.type, n_params / 1e6)

    def _fresh_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Freshly drawn parameters of the config's model (the IL ``full`` reset)."""
        fresh = model_entry(self.config.model, self.device, generator=generator)
        return {n: p.detach() for n, p in fresh.named_parameters()}

    def _build_optimizer(self):
        opt_cfg = self.config.optimizer
        pconfig = opt_cfg.get("pconfig", {})
        kwargs = opt_cfg.get("kwargs", {})
        self.wd_tree = build_wd_tree(self.params, float(kwargs.get("weight_decay", 0.0)), pconfig)
        # the port's AdamW keeps fp32 moments and raises on any other dtype
        moment_dtype = opt_cfg.get("moment_dtype")
        opt_state = adamw_init(self.params, getattr(torch, moment_dtype) if moment_dtype else None)
        trainable = trainable_mask_tree(self.params, frozenset())
        stored = self.params["space_dict"] if self.is_fdt else None
        self.state = TrainState.create(self.params, opt_state, trainable, stored)
        betas = kwargs.get("betas", [0.9, 0.98])
        self._adam_kw = dict(b1=float(betas[0]), b2=float(betas[1]),
                             eps=float(kwargs.get("eps", 1e-8)))

    def _build_data(self):
        dcfg = self.config.data.train
        if dcfg.get("synthetic", False):
            self.train_data = None
            self._synthetic = SyntheticClipData(
                batch_size=int(dcfg.batch_size),
                image_size=self.model.vision_cfg.input_resolution,
                context_length=self.model.text_cfg.context_length,
                num_batches=int(dcfg.get("num_batches", 100)),
                correlated=bool(dcfg.get("correlated", False)),
                num_classes=int(dcfg.get("num_classes", 64)),
                two_views=bool(dcfg.get("two_views", False)),
                mask_type=dcfg.get("mask_type"),
                # disjoint per-rank streams (and class partitions)
                rank=self.rank,
                world_size=self.world_size,
            )
            self.num_batches_per_epoch = self._synthetic.num_batches
            self._sync_buckets = ()
            return
        self._synthetic = None
        # crops and contexts follow the towers unless the config names them
        # (the reference hard-codes 224)
        if "image_size" not in dcfg:
            dcfg["image_size"] = int(self.model.vision_cfg.input_resolution)
        if "context_length" not in dcfg:
            dcfg["context_length"] = int(self.model.text_cfg.context_length)
        self.train_data = get_wds_dataset(dcfg, world_size=self.world_size, rank=self.rank,
                                          tokenizer=get_tokenizer(), seed=self.seed)
        self.num_batches_per_epoch = self.train_data.num_batches
        # the loader says whether it deferred the buckets to this loop
        self._sync_buckets = self.train_data.deferred_buckets
        if self._sync_buckets:
            self.logger.info("synced context buckets across %d ranks: %s", self.world_size,
                             list(self._sync_buckets))

    def _build_lr_scheduler(self):
        sched_cfg = Config(self.config.lr_scheduler.to_dict())
        reset_cfg = self.config.get("reset", {}) or {}
        sched_cfg.kwargs.reset_steps = (int(reset_cfg.get("reset_steps", 0))
                                        if reset_cfg.get("enable", False) else 0)
        self.lr_schedule = scheduler_entry(sched_cfg)
        self.max_iter = int(self.config.lr_scheduler.kwargs.get("max_iter", 0))
        gc = self.config.get("grad_clip", {}) or {}
        self.train_step = make_train_step(
            self.train_model, self.lr_schedule, self.wd_tree, is_fdt=self.is_fdt,
            grad_clip_type=gc.get("type", "none"),
            grad_clip_value=float(gc.get("value", 0.0) or 0.0),
            grad_clip_max_value=float(gc.get("max_value", 0.0) or 0.0),
            lipreg_lambda=self.lipreg_lambda, **self._adam_kw)
        self.eval_step = make_eval_step(self.model, is_fdt=self.is_fdt)

    def _build_il(self):
        rcfg = self.config.get("reset", {}) or {}
        self.reset_cfg = ResetConfig(
            enable=bool(rcfg.get("enable", False)),
            reset_steps=int(rcfg.get("reset_steps", 0) or 0),
            reset_nums=int(rcfg.get("reset_nums", 0) or 0),
            smooth_steps=int(rcfg.get("smooth_steps", 0) or 0),
            semantics=rcfg.get("semantics", "reference"),
            reset_optimizer_state=bool(rcfg.get("reset_optimizer_state", True)),
            freeze_vision_during_smooth=bool(rcfg.get("freeze_vision_during_smooth", True)),
        )
        self.il = ILController(self.reset_cfg, seed=self.seed + 1, model=self.model,
                               init_fn=self._fresh_params, logger=self.logger)

    def reinitialize(self, seed: int, output_path: Optional[str] = None,
                     exp_name: str = "run", reset_enable: Optional[bool] = None,
                     lr: Optional[float] = None):
        """Re-draw the parameters (in place, as a fresh Solver with ``seed``
        draws them), the optimizer, the data and the IL controller, for
        matched-seed arms in one process (``tools/il_effectiveness_ab.py``).
        ``reset_enable`` flips the IL schedule and ``lr`` overrides the base
        and warmup LR; the eager step is rebuilt with the schedule."""
        self.seed = seed
        if reset_enable is not None:
            if "reset" not in self.config:
                self.config.reset = {}
            self.config.reset["enable"] = bool(reset_enable)
        if lr is not None:
            self.config.lr_scheduler.kwargs["base_lr"] = float(lr)
            self.config.lr_scheduler.kwargs["warmup_lr"] = float(lr)
        init_module_tree(self.model, self._generator(seed))
        self._build_optimizer()
        self._build_data()
        self._build_lr_scheduler()
        self._build_il()
        self._last_iter = 0
        if output_path is not None:
            self._set_output(output_path, exp_name)
        return self

    # -- loop ----------------------------------------------------------------
    def _batches(self, epoch: int, skip: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """The epoch's batches on the device, two staged ahead. A mid-epoch
        resume starts at batch ``skip`` and gets, bit for bit, the batches the
        run that saved got from there on: each synthetic batch is keyed by its
        index (the skipped ones are never drawn), and the shard stream is keyed
        by (seed, epoch) with its per-sample augment seeds drawn in stream
        order, so the skipped batches are decoded on the host but never copied.
        With synced buckets the ranks agree on each batch's context here, on
        the thread that runs the steps, one batch ahead, from the captions'
        lengths taken on the host."""
        if self._synthetic is not None:
            it = self._synthetic.batches(skip)
        else:
            self.train_data.set_epoch(epoch)
            it = itertools.islice(self.train_data.dataloader, skip, None)
        if not self._sync_buckets:
            return prefetch_to_device(it, self.device, size=2)
        lengths: collections.deque = collections.deque()
        it = prefetch_to_device(caption_lengths(it, lengths), self.device, size=2)
        return synced_bucket_batches(it, self._sync_buckets, lengths)

    def train(self):
        # in-flight async checkpoint writes reach the disk even when the loop
        # raises or is interrupted
        try:
            state = self._train()
        finally:
            wait_for_saves()
        # rank 0's last checkpoint is whole before any rank goes on to read it
        barrier()
        return state

    def _train(self):
        cfg = self.config
        saver = cfg.get("saver", {}) or {}
        print_freq = int(saver.get("print_freq", 100))
        save_freq = int(saver.get("save_freq", 0) or 0)
        val_freq = int(saver.get("val_freq", 6000) or 6000)
        epochs = int(cfg.data.train.get("epoch", 1))
        total_step = self.max_iter or epochs * self.num_batches_per_epoch
        t_decay = cfg.get("t_decay", None)
        default_T = float(self.model.fdt_cfg.sd_temperature) if self.is_fdt else 0.0

        meters = {k: AverageMeter(print_freq)
                  for k in ("loss", "acc1", "acc5", "batch_time")}
        self.meters = meters
        step = self._last_iter
        self.logger.info(
            "training: %d batches/epoch, %d epochs, total_step %d, world %d",
            self.num_batches_per_epoch, epochs, total_step, self.world_size,
        )
        if self._last_iter >= total_step:
            # reference main() skips training when last_iter >= max_iter
            # (train_solver.py:744-747)
            self.logger.info("resume step %d >= total_step %d: nothing to do",
                             self._last_iter, total_step)
            return self.state
        # A resume skips the fully consumed epochs and, mid-epoch, the first
        # `last_iter % num_batches_per_epoch` batches of the next (JAX
        # solver.py:499-527); the loop still grants `epochs` passes from the
        # resume point, so total_step governs the stop.
        start_epoch = (self._last_iter // self.num_batches_per_epoch
                       if self.num_batches_per_epoch else 0)
        resume_skip = (self._last_iter % self.num_batches_per_epoch
                       if self.num_batches_per_epoch else 0)
        if resume_skip:
            self.logger.info(
                "mid-epoch resume: skipping the first %d batches of epoch %d "
                "(deterministic skip-into-epoch)", resume_skip, start_epoch)
        # per-step metrics stay device scalars until a log boundary, where the
        # crash detector checks every one of them
        pending: list = []
        done = False
        end = time.time()
        # a partial resume epoch contributes fewer batches; grant one more
        # epoch so the remaining-budget semantics still reach total_step
        for epoch in range(start_epoch, start_epoch + epochs + (1 if resume_skip else 0)):
            if done:
                break
            batches = iter(self._batches(epoch,
                                         skip=resume_skip if epoch == start_epoch else 0))
            while True:
                with span("solver.next_batch", step=step + 1):
                    batch = next(batches, None)
                if batch is None:
                    break
                step += 1
                temperature = fdt_temperature(step, t_decay, default_T) if self.is_fdt else 0.0
                metrics = self.train_step(self.state, batch, temperature)
                with span("il.on_step", step=step):
                    self.state = self.il.on_step(self.state, step)
                pending.append((step, metrics["loss"], metrics["acc1"], metrics["acc5"],
                                metrics["lr"]))

                meters["batch_time"].update(time.time() - end)
                end = time.time()
                if step % print_freq == 0 or step % 50 == 0:
                    # reading the window's device scalars waits for the device
                    with span("solver.log", step=step):
                        m = {k: float(v) for k, v in metrics.items()}
                        # loss-crash detector: every step in the window is checked
                        # against the running average before it enters the meter
                        for s, lval, a1, a5, lrv in pending:
                            lval = float(lval)
                            prev_avg = (meters["loss"].avg if meters["loss"].count
                                        or meters["loss"]._hist else None)
                            if s > 100 and prev_avg and lval > prev_avg + 0.5:
                                self.logger.error(
                                    "[CRASH] training loss jumped: %.4f -> %.4f at step %d "
                                    "(lr %.3e)", prev_avg, lval, s, float(lrv),
                                )
                            meters["loss"].update(lval)
                            meters["acc1"].update(float(a1))
                            meters["acc5"].update(float(a5))
                        pending = []
                        if step % print_freq == 0:
                            remain = (total_step - step) * meters["batch_time"].avg
                            ctx = batch["tokens"].shape[1]
                            self.logger.info(
                                "Iter [%d/%d] loss %.4f (%.4f) acc1 %.2f lr %.3e "
                                "logit_scale %.3f T %.3f bt %.3fs eta %.0fmin ctx %d",
                                step, total_step, m["loss"], meters["loss"].avg,
                                m["acc1"], m["lr"], m["logit_scale"], temperature,
                                meters["batch_time"].avg, remain / 60, ctx,
                            )
                            self.metrics_writer.log(
                                {"loss_all": m["loss"], "acc1_train": m["acc1"],
                                 "acc5_train": m["acc5"], "lr": m["lr"],
                                 "logit_scale": m["logit_scale"],
                                 "batch_time": meters["batch_time"].avg},
                                step=step,
                            )

                if val_freq and step % val_freq == 0:
                    self.evaluate(step)
                if save_freq and (step % save_freq == 0 or step == total_step):
                    path = save_checkpoint(
                        self.save_path, self.model, self.state, step,
                        k_times_every=save_freq * 10,
                        # async by default: the host copy is taken before the
                        # next step updates the parameters, the write overlaps it
                        use_async=bool(saver.get("async_save", True)),
                    )
                    self.logger.info("saving checkpoint %s", path)
                if step >= total_step:
                    done = True
                    break
        return self.state

    # -- eval hooks ----------------------------------------------------------
    @contextlib.contextmanager
    def _eval_encoder(self):
        """A ``TorchEncoder`` over the Solver's model and tokenizer (JAX builds
        a ``JitEncoder`` with the encoder's defaults the same way). The
        encoder puts the model in eval mode; it goes back to its mode after.
        Encoding reads the parameters under ``inference_mode`` and draws from
        no random stream, so the run trains on bit for bit as without it."""
        from ..eval.encode import TorchEncoder

        mode = self.model.training
        try:
            yield TorchEncoder(self.model, tokenizer=self.tokenizer,
                               data_parallel=self.world_size > 1)
        finally:
            self.model.train(mode)

    def evaluate(self, step: int):
        """In-training SugarCREPE eval (reference train_solver.py:623-678; JAX
        ``Solver.evaluate``); None when ``data.test.sc_data_root`` is unset or
        missing."""
        test_cfg = self.config.data.get("test", {}) or {}
        data_root = test_cfg.get("sc_data_root")
        image_root = test_cfg.get("sc_image_root")
        if not data_root or not os.path.isdir(str(data_root)):
            return None
        from ..eval.sugar_crepe import evaluate_sugar_crepe

        with self._eval_encoder() as encoder:
            metrics = evaluate_sugar_crepe(
                encoder, data_root=str(data_root), image_root=str(image_root)
            )
        for k, v in metrics.items():
            self.logger.info("eval step %d: %s = %.4f", step, k, v)
        # best-composition-score tracking (reference train_solver.py:657-667:
        # keeps the best split dict and flags a >0.003 mean drop; the caller
        # there ignores the flag, kept as in JAX)
        mean_score = float(np.mean(list(metrics.values()))) if metrics else 0.0
        prev = getattr(self, "best_composition_score", None)
        improved = True
        if prev:
            prev_mean = float(np.mean(list(prev.values())))
            if mean_score + 0.003 < prev_mean:
                improved = False
        if improved:
            self.best_composition_score = dict(metrics)
        self.metrics_writer.log(
            {**{f"eval/{k}": v for k, v in metrics.items()},
             "eval/sugar-crepe-mean-score": mean_score},
            step=step,
        )
        return metrics

    def imagenet_evaluate(self, step: int):
        """In-training zero-shot classification (reference train_solver.py:683-716;
        JAX ``Solver.imagenet_evaluate``) over a local dataset at
        ``data.test.imagenet_root``, a wds-protocol directory or class folders;
        None when it is unset or missing."""
        test_cfg = self.config.data.get("test", {}) or {}
        root = test_cfg.get("imagenet_root")
        if not root or not os.path.isdir(str(root)):
            return None
        from ..eval.builder import build_folder_dataset, build_wds_dataset
        from ..eval.zeroshot_classification import evaluate_zeroshot_classification

        root = str(root)
        if os.path.exists(os.path.join(root, "classnames.txt")):
            ds = build_wds_dataset(root, "imagenet")
        else:
            ds = build_folder_dataset(root, "imagenet")
        with self._eval_encoder() as encoder:
            metrics = evaluate_zeroshot_classification(
                encoder, ds.images, ds.labels, ds.classnames, ds.templates
            )
        for k, v in metrics.items():
            self.logger.info("imagenet step %d: %s = %.4f", step, k, v)
        self.metrics_writer.log({f"eval/ImageNet_{k}": v for k, v in metrics.items()},
                                step=step)
        return metrics
