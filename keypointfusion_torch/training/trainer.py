"""Trainer: the train / test / evaluation harness (port of
keypointfusion_tpu/training/trainer.py, itself the reference's train.py
Trainer).

  * train(): epochs of make_train_step (or make_train_step_scan with
    cfg.steps_per_dispatch > 1) over a shuffled BatchLoader whose batches
    device_prefetch copies to the card ahead of the step; after each
    epoch test() and the reference's best/latest checkpoint policy, with
    scheduler='auto''s plateau decay through TrainState.lr_scale.
  * Checkpoints are torch.save files holding the whole run: the model's
    and the optimizer's state_dicts, the schedule, step, epoch, lr_scale,
    the best error and the plateau count, so a resume continues the run
    (the reference saves the optimizer and the epoch but never restores
    them).
  * Dropout draws from one torch.Generator per epoch on the model's
    device, seeded by a fixed function of (cfg.seed + 1, epoch): a run
    resumed at epoch k draws what the straight run drew, as the JAX
    trainer's fold_in of the epoch gives.
  * test(): per-stage mean and Procrustes-aligned errors (one batched SVD
    for every stage of a batch, one device-to-host copy per batch), the
    AUC printouts, the test_{i}.txt / id.txt dumps, the last partial
    batch padded; evaluation(): the HO3D dump, padded the same way.

Datasets (`train_data`, `test_data`: indexable samples of numpy arrays,
synthetic_batch's keys) are given to the trainer, or loaded from
cfg.root_dir by data/datasets.py:make_dataset(cfg, split) as the JAX
trainer does: the train split when phase='train' and no train_data is
given, the test split when phase is 'train' or 'test' and no test_data
is given. A test split that fails to load leaves test_data None, as in
the JAX trainer, but the failure is logged to train.log and printed.
phase='eval' loads what evaluation() reads: HO3D's 'evaluation' split
(the reference's codalab split) or the test split of the others; the JAX
trainer loads nothing there, and its evaluation() fails on None.

Under a process group (`group`, one rank per card, as
`python -m torch.distributed.run` starts them; the JAX trainer's mesh):
  * the world is the largest size that divides cfg.batch_size, as
    auto_mesh picks it; ranks beyond it stay idle;
  * each rank builds the state, loads the warm starts or the resume, and
    takes rank 0's parameters and statistics (broadcast_module);
  * train() steps make_train_step(cfg, group) (cfg.sync_batchnorm picks
    the BatchNorm policy), each rank loading only its rows of every
    global batch of the one shuffled order. Each rank's dataset draws its
    augmentations and point samples for its own rows only, so with a
    world above 1 the draws differ from a one-process run's; the dropout
    generator of a rank is seeded by (seed, epoch, rank);
  * test() and evaluation() load every global batch whole on each rank,
    so that the samples are those of a one-process run (eval samples
    draw points from the dataset's RNG too); each rank runs the eval
    forward on its rows and the results are gathered in row order
    (make_eval_step(cfg, group)); the last batch is padded to
    cfg.batch_size, which the world divides;
  * only rank 0 writes train.log, the metrics, config.json, the
    test_*.txt and id.txt dumps, pred.json and the checkpoints; every
    rank computes the same errors, so the best/plateau decisions agree.

config.json holds the run's values (dataclasses.asdict); the JAX trainer
writes vars(type(cfg)), the dataclass's defaults.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.datasets import make_dataset
from keypointfusion_torch.data.pipeline import (
    BatchLoader, collate, device_prefetch,
)
from keypointfusion_torch.data.synthetic import synthetic_batch
from keypointfusion_torch.geometry.camera import (
    uvd_nl_to_xyz_nl, xyz_nl_to_uvd_nl,
)
from keypointfusion_torch.ops.codecs_extra import feature_to_joint
from keypointfusion_torch.parallel.mesh import (
    auto_world, broadcast_module, rank_of, shard_batch, subgroup,
    world_size,
)
from keypointfusion_torch.training.metrics import (
    auc_subset, pa_error_mm, pck_curve, xyz_to_error_mm,
)
from keypointfusion_torch.training.train_step import (
    LrSchedule, TrainState, create_train_state, frame_from_batch,
    make_eval_step, make_train_step, make_train_step_scan,
)
from keypointfusion_torch.utils.device import resolve_device
from keypointfusion_torch.utils.pretrain import imagenet_backbone_state_dict
from keypointfusion_torch.utils.provenance import snapshot_sources
from keypointfusion_torch.utils.vis import draw_2d_pose, draw_2d_pose_rgb
from keypointfusion_torch.utils.weights import (
    load_torch_checkpoint, merge_partial,
)

MANO2HO3D = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
             20, 16, 17, 19, 18]


def epoch_seed(seed: int, epoch: int, rank: Optional[int] = None) -> int:
    """The dropout generator's seed for `epoch` of a run seeded `seed`
    (and, under a process group, for `rank`)."""
    entropy = [seed, epoch] if rank is None else [seed, epoch, rank]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])


class MetricsLogger:
    """JSONL metrics log, and tensorboard scalars when a writer imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(osp.join(log_dir, 'metrics.jsonl'), 'a')
        try:
            from tensorboardX import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except Exception:
            self.tb = None

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {'step': int(step), **{k: float(v) for k, v in
                                     metrics.items()}}
        self.jsonl.write(json.dumps(rec) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), global_step=step)


class _NoLogger:
    """The metrics logger of a rank other than 0: it writes nothing."""
    tb = None

    def log(self, step: int, metrics: Dict[str, float]):
        pass


class Checkpointer:
    """Named checkpoints ('best', 'latest') of the whole train state, one
    torch.save file each, written to a temporary name and renamed. The
    optimizer's state loads into the state's own optimizer, built by
    create_train_state over the model's parameters in their order. The
    JAX Checkpointer default-fills checkpoints written before it stored
    the scheduler's fields; no port checkpoint lacks them, so there is no
    counterpart."""

    def __init__(self, ckpt_dir: str):
        self.dir = osp.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, name: str) -> str:
        return osp.join(self.dir, f'{name}.pth')

    def save(self, name: str, state: TrainState, epoch: int,
             min_error: float = float('inf'), plateau: int = 0):
        payload = {'model': state.model.state_dict(),
                   'optimizer': state.optimizer.state_dict(),
                   'schedule': dataclasses.asdict(state.schedule),
                   'step': int(state.step), 'epoch': int(epoch),
                   'lr_scale': float(state.lr_scale),
                   'min_error': float(min_error), 'plateau': int(plateau)}
        tmp = self.path(name) + '.tmp'
        torch.save(payload, tmp)
        os.replace(tmp, self.path(name))

    def _load(self, name: str) -> dict:
        """The payload on the CPU: load_state_dict moves the weights and
        the moments to the parameters' device, and leaves AdamW's step
        counts on the host, where torch keeps them (counts on the card
        cost a wait for the card per parameter and step)."""
        return torch.load(self.path(name), map_location='cpu',
                          weights_only=True)

    def restore(self, name: str, state: TrainState):
        """The whole state: weights, statistics, optimizer, schedule,
        step and lr_scale, in place. Returns (state, epoch, min_error,
        plateau)."""
        payload = self._load(name)
        state.model.load_state_dict(payload['model'])
        state.optimizer.load_state_dict(payload['optimizer'])
        state.schedule = LrSchedule(**payload['schedule'])
        state.step = int(payload['step'])
        state.lr_scale = float(payload['lr_scale'])
        return (state, int(payload['epoch']), float(payload['min_error']),
                int(payload['plateau']))

    def restore_weights(self, name: str, state: TrainState) -> TrainState:
        """The weights and statistics only (a warm start)."""
        state.model.load_state_dict(self._load(name)['model'])
        return state


class Trainer:
    """Construction: the sample batch, the state (weights from cfg.seed),
    then the warm starts in the JAX trainer's order (cfg.pretrain,
    cfg.load_model, cfg.finetune_dir) and cfg.resume. The model runs on
    the CUDA card unless `device` names another. `group`: the process
    group to train and test under (see the module's docstring; None: one
    process).

    `loader_threads` is BatchLoader's thread count (8, the JAX trainer's).
    A dataset draws its augmentations and point samples from one RNG in
    the order the threads reach it, so with more than one thread the
    draws, and test()'s errors, follow the threads' timing (in the JAX
    trainer too); with 1 they are the same from run to run."""

    def __init__(self, cfg: Config, train_data=None, test_data=None,
                 model_dir: Optional[str] = None, device=None,
                 loader_threads: int = 8, group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loader_threads = loader_threads
        self.group, self.idle = group, False
        if group is not None:
            world = auto_world(cfg.batch_size, world_size(group))
            self.group = subgroup(group, world)
            self.idle = self.group is None
            if self.idle:
                print(f'Trainer: rank {rank_of(group)} is outside the world '
                      f'of {world} ranks that divides batch_size '
                      f'{cfg.batch_size}; it stays idle')
                return
        self.rank, self.world = rank_of(self.group), world_size(self.group)
        if train_data is None and cfg.phase == 'train':
            train_data = make_dataset(cfg, 'train')
        test_error = None
        if test_data is None and cfg.phase in ('train', 'test'):
            try:
                test_data = make_dataset(cfg, 'test')
            except Exception as e:   # the JAX trainer goes on without it
                test_error = e
        elif test_data is None and cfg.phase == 'eval':
            test_data = make_dataset(
                cfg, 'evaluation' if cfg.dataset == 'ho3d' else 'test')
        self.train_data = train_data
        self.test_data = test_data

        self.model_dir = model_dir or osp.join(
            cfg.save_dir, 'checkpoint', cfg.dataset,
            cfg.net + ('_' + cfg.model_save if cfg.model_save else ''))
        os.makedirs(self.model_dir, exist_ok=True)
        self.logger = _NoLogger()
        if self.rank == 0:
            with open(osp.join(self.model_dir, 'config.json'), 'w') as f:
                json.dump(dataclasses.asdict(cfg), f, default=str, indent=1)
            snapshot_sources(osp.join(self.model_dir, 'files'))
            logging.basicConfig(
                filename=osp.join(self.model_dir, 'train.log'),
                level=logging.INFO, force=False)
            if test_error is not None:
                logging.error('the test split of %s did not load; test() '
                              'is off: %r', cfg.dataset, test_error)
                print(f'Trainer: the test split of {cfg.dataset} did not '
                      f'load ({test_error!r}); test() is off')
            self.logger = MetricsLogger(osp.join(self.model_dir, 'runs'))
        self.ckpt = Checkpointer(osp.join(self.model_dir, 'ckpt'))

        nb = (len(train_data) // cfg.batch_size
              if train_data is not None else 1000)
        self.state = create_train_state(cfg, self._sample_batch(),
                                        device=self.device, seed=cfg.seed,
                                        steps_per_epoch=max(nb, 1))
        if cfg.pretrain:
            self._load_imagenet_pretrain()
        for source in (cfg.load_model, cfg.finetune_dir):
            if source:
                self._warm_start(source)
        self.train_step = make_train_step(cfg, self.group)
        self.train_scan = make_train_step_scan(cfg, self.group) \
            if cfg.steps_per_dispatch > 1 else None
        self.eval_step = make_eval_step(cfg, self.group)
        self.min_error = float('inf')
        self.start_epoch = 0
        self.plateau_patience = 3   # scheduler='auto' epochs w/o improvement
        self._plateau = 0
        if cfg.resume:
            self.resume('latest')
        broadcast_module(self.state.model, self.group)

    def resume(self, name: str = 'latest'):
        """The whole run's state from checkpoint `name`; training goes on
        at the epoch after the one it was saved at."""
        self.state, epoch, self.min_error, self._plateau = \
            self.ckpt.restore(name, self.state)
        self.start_epoch = epoch + 1
        logging.info('resumed from %s at epoch %d (lr_scale %.3e)', name,
                     epoch, self.state.lr_scale)

    def _merge(self, loaded: Dict[str, torch.Tensor], what: str):
        merged, used, skipped = merge_partial(
            self.state.model.state_dict(), loaded)
        self.state.model.load_state_dict(merged)
        logging.info('%s: %d tensors merged, %d skipped (shape mismatch)',
                     what, len(used), len(skipped))
        if skipped:
            logging.info('skipped: %s', skipped[:8])

    def _load_imagenet_pretrain(self):
        """The backbones' ImageNet warm start (utils/pretrain.py). No
        checkpoint on disk: raises if cfg.pretrain_dir was set, else the
        random init stays."""
        pre = imagenet_backbone_state_dict(self.cfg)
        if pre is None:
            logging.info('pretrain=%r: no ImageNet checkpoint on disk; the '
                         'backbones keep their random init',
                         self.cfg.pretrain)
            return
        self._merge(pre, 'ImageNet warm start')

    def _warm_start(self, source: str):
        """A `.pth` (a released reference checkpoint, or a port one),
        merged where names and shapes agree; any other name is a
        checkpoint of this trainer's, whose weights load whole."""
        if source.endswith('.pth'):
            self._merge(load_torch_checkpoint(source),
                        f'warm start from {source}')
        else:
            self.ckpt.restore_weights(source, self.state)

    def _sample_batch(self):
        if self.train_data is not None:
            return collate([self.train_data[0]] * 2)
        return synthetic_batch(batch_size=2, point_num=self.cfg.point_num)

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The dropout generator of `epoch` (and of this rank under a
        process group of more than one), on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(epoch_seed(self.cfg.seed + 1, epoch,
                                   self.rank if self.world > 1 else None))
        return gen

    def _save(self, name: str, epoch: int):
        """Checkpoint `name`, written by rank 0 alone."""
        if self.rank == 0:
            self.ckpt.save(name, self.state, epoch, self.min_error,
                           self._plateau)

    # ------------------------------------------------------------- train --

    def train(self):
        if self.idle:
            return None
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.max_epoch):
            loader = BatchLoader(self.train_data, cfg.batch_size,
                                 shuffle=True,
                                 num_workers=self.loader_threads,
                                 seed=cfg.seed + epoch,
                                 shard=(self.rank, self.world))
            generator = self.epoch_generator(epoch)
            t0 = time.time()
            if self.train_scan is not None:
                metrics = self._run_epoch_scan(loader, generator, epoch, t0)
            else:
                metrics = None
                for ii, batch in enumerate(device_prefetch(loader,
                                                           self.device)):
                    self.state, metrics = self.train_step(
                        self.state, batch, generator, epoch)
                    if ii % 50 == 0:
                        self._log_step(metrics, ii + 1, t0)

            if self.test_data:
                test_error = self.test(epoch)
            elif metrics is not None:
                test_error = float(metrics['loss'])
            else:
                logging.warning('epoch %d produced no batches', epoch)
                test_error = float('inf')
            if test_error <= self.min_error:
                self.min_error = test_error
                self._plateau = 0
                self._save('best', epoch)
            elif cfg.scheduler == 'auto':
                # reduce-on-plateau, the intent of the reference's 'auto'
                # branch (which feeds the error to StepLR.step as an epoch)
                self._plateau += 1
                if self._plateau >= self.plateau_patience:
                    self._plateau = 0
                    self.state.lr_scale *= cfg.step_gamma
                    logging.info('plateau: lr_scale -> %.3e',
                                 self.state.lr_scale)
            self._save('latest', epoch)
            logging.info('epoch %d done, test_error %.4f', epoch,
                         test_error)
        return self.min_error

    def _log_step(self, metrics, steps_done: int, t0: float):
        """One copy of every metric to the host (rank 0's): the loop's only
        wait for the card besides the step's own."""
        if self.rank != 0:
            return
        names = list(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        host = dict(zip(names, values))
        host['steps_per_sec'] = steps_done / (time.time() - t0)
        self.logger.log(self.state.step, host)

    def _run_epoch_scan(self, loader, generator, epoch: int, t0: float):
        """cfg.steps_per_dispatch = G > 1: G consecutive loader batches
        stacked and run by make_train_step_scan, the same steps on the
        same draws as single steps; the trailing len(loader) % G batches
        take single steps."""
        G = self.cfg.steps_per_dispatch
        tail = []

        def grouped():
            group = []
            for b in loader:
                group.append(b)
                if len(group) == G:
                    yield {k: np.stack([g[k] for g in group])
                           for k in group[0]}
                    group = []
            tail.extend(group)

        metrics = None
        steps_done = 0
        log_every = max(1, 50 // G)
        for gi, stacked in enumerate(device_prefetch(grouped(),
                                                     self.device)):
            self.state, stacked_metrics = self.train_scan(
                self.state, stacked, [generator] * G, epoch)
            steps_done += G
            metrics = {k: v[-1] for k, v in stacked_metrics.items()}
            if gi % log_every == 0:
                self._log_step(metrics, steps_done, t0)
        for batch in device_prefetch(tail, self.device):
            self.state, metrics = self.train_step(self.state, batch,
                                                  generator, epoch)
        return metrics

    # -------------------------------------------------------------- eval --

    def _decode_stage(self, results, batch, frame, index, stage):
        """Stage `index`'s joints in normalized xyz: 0, the raw uvd
        output; 1, the dense map decoded by the feature type; else the
        block's joints."""
        if stage == 0:
            return uvd_nl_to_xyz_nl(results[index], frame)
        if stage == 1:
            joint_uvd = feature_to_joint(batch['depth'], results[index],
                                         self.cfg.feature_type,
                                         self.cfg.feature_para,
                                         joint_num=self.cfg.joint_num)
            return uvd_nl_to_xyz_nl(joint_uvd, frame)
        return results[index]

    @staticmethod
    def _pad_batch(batch, batch_size: int):
        """A partial last batch padded to full size by repeating its last
        sample (a multiple of the world, which divides batch_size);
        returns (batch, n_real)."""
        n = next(iter(batch.values())).shape[0]
        if n == batch_size:
            return batch, n
        pad = batch_size - n
        return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                for k, v in batch.items()}, n

    def _padded_batches(self, data, n_real: list):
        """`data` in batches of cfg.batch_size on the device, the last
        padded; each batch's count of real samples appended to n_real
        before the batch is handed out."""
        loader = BatchLoader(data, self.cfg.batch_size, shuffle=False,
                             num_workers=self.loader_threads,
                             drop_last=False)

        def padded():
            for raw in loader:
                batch, n = self._pad_batch(raw, self.cfg.batch_size)
                n_real.append(n)
                yield batch

        return device_prefetch(padded(), self.device)

    def _eval(self, batch):
        """The eval forward of the whole batch: under a process group each
        rank runs its rows and the results come back gathered."""
        if self.world > 1:
            return self.eval_step(self.state, shard_batch(
                batch, self.rank, self.world))
        return self.eval_step(self.state, batch)

    def _stage_results(self, batch) -> np.ndarray:
        """Every stage's errors and world-mm joints for one batch on the
        host, [stages, B, J, 5]: the error, the Procrustes-aligned error,
        then x, y, z."""
        results, _ = self._eval(batch)
        frame = frame_from_batch(batch, self.cfg)
        joints = torch.stack([
            self._decode_stage(results, batch, frame, index, stage).float()
            for index, stage in enumerate(self.cfg.stage_type)])
        gt = batch['xyz_gt'].expand_as(joints)
        err = xyz_to_error_mm(joints, gt, batch['center'], batch['cube'])
        pa = pa_error_mm(joints, gt, batch['center'], batch['cube'])
        world = (joints * batch['cube'][:, None] / 2
                 + batch['center'][:, None])
        return torch.cat([err[..., None], pa[..., None], world],
                         -1).cpu().numpy()

    def test(self, epoch: int = -1) -> float:
        """Per-stage mean and Procrustes-aligned errors, the AUC
        printouts, and the dumps: test_{i}.txt holds stage i's world-mm
        joints, one sample a line, and id.txt the sample ids. Returns the
        last stage's mean error. Under a process group every rank
        returns it and rank 0 alone prints and writes."""
        if self.idle:
            return None
        if self.test_data is None:
            raise RuntimeError(
                'no test split: pass test_data, or a cfg.root_dir that '
                'holds the test split of cfg.dataset')
        n_stage = len(self.cfg.stage_type)
        err_sum = np.zeros(n_stage)
        pa_sum = np.zeros(n_stage)
        first_last_errors = [[], []]
        n_real = []
        writing = self.rank == 0
        result_files = [open(osp.join(self.model_dir, f'test_{i}.txt'), 'w')
                        for i in range(n_stage)] if writing else []
        id_file = open(osp.join(self.model_dir, 'id.txt'), 'w') \
            if writing else None
        sample_id = 0
        try:
            for nb, batch in enumerate(self._padded_batches(self.test_data,
                                                            n_real)):
                n = n_real[nb]
                host = self._stage_results(batch)[:, :n]
                for index in range(n_stage):
                    err_sum[index] += float(np.mean(host[index, ..., 0]))
                    pa_sum[index] += float(np.mean(host[index, ..., 1]))
                    if writing:
                        for row in host[index, ..., 2:].reshape(n, -1):
                            result_files[index].write(
                                ' '.join(f'{v:.3f}' for v in row) + '\n')
                first_last_errors[0].append(host[0, ..., 0])
                first_last_errors[1].append(host[-1, ..., 0])
                if writing:
                    for i in range(n):
                        id_file.write(f'{sample_id + i}\n')
                sample_id += n
        finally:
            for f in result_files:
                f.close()
            if id_file is not None:
                id_file.close()
        nb = len(n_real)
        if nb == 0:
            return float('inf')
        if not writing:
            return float(err_sum[-1] / nb)

        for which, name in ((0, 'stage 0'), (1, 'stage -1')):
            errors = np.concatenate(first_last_errors[which], 0)
            auc, curve, th = pck_curve(errors)
            print(f'{name}: Area under curve: {auc:.3f}')
            print(f'{name}: Area under curve between 20mm - 50mm: '
                  f'{auc_subset(curve, th):.3f}')

        info = f'{epoch} epochs: '
        for index in range(n_stage):
            print(f'[mean_Error {err_sum[index] / nb:.3f}]')
            print(f'[PA_mean_Error {pa_sum[index] / nb:.3f}]')
            info += (f' error{index}: {err_sum[index] / nb:.3f} '
                     f'PA{index}: {pa_sum[index] / nb:.3f}')
        logging.info(info)
        self.logger.log(self.state.step, {f'error_{i}': err_sum[i] / nb
                                          for i in range(n_stage)})
        return float(err_sum[-1] / nb)

    def _log_eval_images(self, batch, joint_xyz, step: int):
        """'eval_img' (the depth crop, BGR) and 'eval_img_rgb' (the colour
        crop, RGB) with the last stage's skeleton of the batch's first
        sample, CHW in [0, 1] (JAX trainer.py:518-537, reference
        train.py:451-457)."""
        frame = frame_from_batch(batch, self.cfg)
        uvd = xyz_nl_to_uvd_nl(joint_xyz.float(), frame)[0].cpu().numpy()
        depth = draw_2d_pose(batch['depth'][0].cpu().numpy(), uvd,
                             self.cfg.dataset)
        self.logger.tb.add_image(
            'eval_img', np.transpose(depth, (2, 0, 1)) / 255.0,
            global_step=step)
        rgb = draw_2d_pose_rgb(batch['rgb'][0].cpu().numpy(), uvd,
                               self.cfg.dataset)
        self.logger.tb.add_image(
            'eval_img_rgb', np.transpose(rgb[..., ::-1], (2, 0, 1)) / 255.0,
            global_step=step)

    def evaluation(self, eval_data=None, out_path: Optional[str] = None):
        """The HO3D codalab dump (pred.json): the last stage's world-mm
        joints in HO3D's joint order, flipped by [1, -1, -1] and in
        metres, and zero meshes. The last partial batch is padded, as in
        test(). With a tensorboard writer, each batch's first sample is
        logged as skeleton overlays, as the JAX trainer logs them. Under a
        process group rank 0 writes the file and every rank returns its
        path."""
        if self.idle:
            return None
        data = eval_data if eval_data is not None else self.test_data
        joint_list = []
        n_real = []
        for nb, batch in enumerate(self._padded_batches(data, n_real)):
            results, _ = self._eval(batch)
            if self.logger.tb is not None:
                self._log_eval_images(batch, results[-1], nb)
            world = (results[-1].float() * batch['cube'][:, None] / 2
                     + batch['center'][:, None])
            world = world.cpu().numpy()[:n_real[nb], MANO2HO3D, :]
            joint_list += list(world * np.array([1, -1, -1]) / 1000)
        mesh = np.zeros([778, 3])
        out_path = out_path or osp.join(self.model_dir, 'pred.json')
        if self.rank != 0:
            return out_path
        with open(out_path, 'w') as f:
            json.dump([[j.tolist() for j in joint_list],
                       [mesh.tolist()] * len(joint_list)], f)
        return out_path
