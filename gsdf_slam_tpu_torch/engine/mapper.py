"""GaussianMapper: the streaming training loop on one device.

Port of `gsdf_slam_tpu/engine/mapper.py` (GaussianMapper,
include/gaussian_mapper.h:102-177, src/gaussian_mapper.cpp). The mapper
owns policy and IO; the per-iteration math is `engine/train.py::train_step`
and the surgery of `models/gaussian_model.py`:

  * the streaming `run()` loop (gaussian_mapper.cpp:160-333): per frame,
    ingest the colourised cloud (create or increase), register a keyframe
    whose pose is the inverse of the loader's camera pose, then train once;
  * shuffled times-of-use keyframe sampling (:503-606), with the JAX
    package's `random.Random(seed)` and call order, so both packages sample
    the same keyframes;
  * Gaussian-pyramid level scheduling (:351-369), cv2 imported where used;
  * the densify / opacity-reset cadence (:449-461); the split's noise is
    drawn from a `torch.Generator` seeded from `seed`;
  * cached binning: each (keyframe, pyramid level)'s `BinningCache` is
    reused for up to rebin_interval - 1 steps while the model's count,
    generation and the image size are those it was built for; every
    surgery drops them all, a keyframe's pose correction drops its own;
  * a precomputed sky mask and camera undistortion (:172-275);
  * the SLAM feed (`feed_keyframe`): RGB-D backprojection, and for an
    image with no depth the monocular inactive-geometry densify (tracker
    points, the map's depth render, a flat prior; a depth cache flushed
    through increase_pcd every max_depth_cached keyframes);
  * tracker pose corrections, with existence pruning after a large one;
  * pipelined metrics (`metrics_pipeline_depth` steps in flight, each
    read from its own pinned host buffer behind a CUDA event, resolved in
    order);
  * checkpoints in the JAX package's `.npz` format, both ways;
  * the live parameter channel (get/set_variable_parameters);
  * results: 3DGS-format PLY + cameras.json + cfg_args (:659-775), and
    the keyframe image record.

Training images are held as tensors on the mapper's device (the card
unless told otherwise). A synchronous step reads its loss and PSNR with
one `.tolist()`; its pair count is already on the host. The map is sized
to its live Gaussians and the pairs exactly, so the JAX package's
capacities, pair autosizing, overflow redo and replay loops, compile
prewarm and device-scalar caches have no counterpart here.

Not ported yet; each raises NotImplementedError naming its ROADMAP item:
the multi-device `mesh` and live sky segmentation (`skyseg_onnx_path`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import random
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..data.loader import DataLoader, FrameData
from ..io.ply import gaussians_to_ply_dict, ply_dict_to_gaussians, read_ply, write_ply, write_sparse_points_ply
from ..models.gaussian_model import (
    STATS, GaussianModel, densify_and_prune, increase_pcd, prune_young, reset_opacity,
)
from ..models.optimizer import PARAM_GROUPS, AdamState
from ..ops.rasterize import RasterizeConfig
from ..ops.transforms import CameraMatrices
from ..utils import rotation_angle
from ..utils.observability import PhaseTimer, using
from .keyframe import Camera, Keyframe, rot_to_quat_wxyz
from .scene import Scene
from .settings import MapperSettings
from .train import render_depth_state, render_state, train_step
from .variable_params import VariableParameters

# the most binning caches held at once (the JAX mapper's bound, :925)
MAX_BIN_CACHES = 32
# where a monocular keyframe's depth samples came from, by code
MONO_SOURCES = ("tracker", "render", "prior")
# returned by _single_step_phase for a step whose metrics are in flight
_PENDING = object()


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to gsdf_slam_tpu_torch yet (ROADMAP {item})")


def _traced(method):
    """An entry point of the mapper: its `timer` is the current tracer
    (`utils/observability.py::using`) inside, so deep ops' spans and
    counters record into it."""

    @functools.wraps(method)
    def entry(self, *args, **kwargs):
        with using(self.timer):
            return method(self, *args, **kwargs)

    return entry


class GaussianMapper:
    def __init__(
        self,
        settings: MapperSettings | None = None,
        dataloader: DataLoader | None = None,
        result_dir: str | Path | None = None,
        ingest_capacity: int = 1 << 16,
        seed: int = 0,
        sky_mask: np.ndarray | None = None,
        mesh=None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        self.settings = settings or MapperSettings()
        self._bg = {False: torch.zeros(3, device=self.device), True: torch.ones(3, device=self.device)}
        if mesh is not None:
            raise _not_ported("multi-device mapping (mesh)", "A6")
        if self.settings.skyseg_onnx_path:
            raise _not_ported("live sky segmentation (skyseg_onnx_path)", "A5")
        self.dataloader = dataloader
        self.result_dir = Path(result_dir) if result_dir else None
        self.ingest_capacity = ingest_capacity
        self.sky_mask = sky_mask  # [H, W] bool, True = sky (blacked out)

        self.scene = Scene()
        self.model: GaussianModel | None = None
        self.adam: AdamState | None = None
        self.iteration = 0
        self.initial_mapped = False
        self.ema_loss = 0.0
        self.spatial_lr_scale = 1.0
        self._rng = random.Random(seed)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._kfid_shuffle: list[int] = []
        self._kfid_shuffle_idx = 0
        self.kfs_used_times: dict[int, int] = {}
        # training images and masks on the device, keyed (kind, fid, level)
        self._images: dict[tuple, torch.Tensor] = {}
        # cross-step binning persistence: (fid, level) -> entry dict (see
        # _dispatch_train_step); dropped on every surgery
        self._bin_cache: dict = {}
        # "fresh", "export" or "cached": the binning of the last step, and
        # the count of each over the mapper's life
        self.last_binning: str | None = None
        self.binning_counts: Counter = Counter()
        self._stopped = False
        # pipelined metrics (settings.metrics_pipeline_depth): the records of
        # dispatched steps whose metrics are not read yet, oldest first, and
        # the last resolved step's metrics
        self._pending: list[dict] = []
        self._last_resolved: dict | None = None
        # if a list, every resolved step's record (iteration, fid, binning,
        # count, loss, psnr) is appended to it, in step order
        self.step_log: list[dict] | None = None
        # setShDegree/oneUpShDegree (gaussian_model.cpp:103-112); None is
        # the max degree, which the reference's run() forces (:375)
        self.active_sh_degree: int | None = None
        # tracker points for input.ply (saveSparsePointsPly,
        # gaussian_model.cpp:955-996)
        self.sparse_points_xyz: list[np.ndarray] = []
        self.sparse_points_color: list[np.ndarray] = []
        # the monocular densify's depth cache (depth_cached_,
        # depth_cache_points_/colors_, include/gaussian_mapper.h:259-262):
        # sample clouds pooled across keyframes, flushed into increase_pcd
        # every max_depth_cached keyframes; and the samples kept, by source
        self.depth_cached = 0
        self.depth_cache_points: list[np.ndarray] = []
        self.depth_cache_colors: list[np.ndarray] = []
        self.mono_sources: Counter = Counter()
        # the last monocular keyframe's samples: pixel rows and columns, the
        # depth each got (NaN where none), its source (-1 where none), and
        # the depth render's depth and coverage where it was read (NaN
        # elsewhere)
        self.last_mono_samples: dict[str, np.ndarray] | None = None
        # per-camera undistortion (gaussian_mapper.cpp:172-204), built at
        # ingest when distortion is present
        self._undistorters: dict[tuple, object] = {}
        self._feed_intrinsics = None  # intrinsics passed with a frame
        self.timer = PhaseTimer()

    # ------------------------------------------------------------------ run
    @_traced  # the loader's colourise spans, too
    def run(self) -> None:
        """Streaming mapping over the whole dataset (run(), :160-333)."""
        assert self.dataloader is not None, "run() needs a dataloader"
        for i in range(len(self.dataloader)):
            if self._stopped:
                break
            self.ingest_frame(i, self.dataloader.get_item(i))
            self.train_for_one_iteration()
        self.flush_metrics()

    def signal_stop(self) -> None:
        self._stopped = True

    # --------------------------------------------------------------- ingest
    @_traced
    def ingest_frame(self, fid: int, frame: FrameData, intrinsics=None) -> Keyframe:
        """Register camera and keyframe and grow the model from the frame's
        cloud, of which the first `ingest_capacity` points are used.
        `intrinsics` (a CameraIntrinsics), if given, is kept for this and
        later frames; else the dataloader's, else a 90-degree camera. Does
        not resolve steps in flight: their metrics are already on their
        way to the host, and the ingest's host work overlaps them."""
        if intrinsics is not None:
            self._feed_intrinsics = intrinsics
        intr = self.dataloader.frames.intrinsics if self.dataloader else None
        if intr is None:
            intr = self._feed_intrinsics
        h, w = frame.image.shape[:2]
        if intr is not None:
            cam = Camera(fid, intr.fx, intr.fy, intr.cx, intr.cy, w, h)
        else:
            cam = Camera(fid, w / 2.0, w / 2.0, w / 2.0, h / 2.0, w, h)
        self.scene.add_camera(cam)

        image = frame.image
        mask = None

        # Undistortion (gaussian_mapper.cpp:172-204, camera.h:72-105): train
        # on the undistorted image and mask the black remap edges out of the
        # loss (:415-417); maps built once per camera geometry.
        dist = getattr(intr, "dist", None) if intr is not None else None
        cam_model = getattr(intr, "model", "pinhole") if intr is not None else "pinhole"
        if dist is not None and np.any(np.asarray(dist) != 0):
            und = self._undistorter(cam.fx, cam.fy, cam.cx, cam.cy, w, h, cam_model, dist)
            image = und.undistort(image).astype(np.float32)
            mask = und.mask

        sky = self.sky_mask
        if sky is not None:
            if sky.shape[:2] != image.shape[:2]:
                import cv2

                sky = cv2.resize(
                    sky.astype(np.uint8), (image.shape[1], image.shape[0]),
                    interpolation=cv2.INTER_NEAREST,
                ).astype(bool)
            image = np.where(sky[..., None], 0.0, image).astype(np.float32)
            # KITTI-mode quirk (gaussian_mapper.cpp:273-275): the training
            # mask is the masked image itself, tested as mask > 0.
            sky_keep = (~sky).astype(np.float32)
            mask = sky_keep if mask is None else mask * sky_keep

        t_cw = np.linalg.inv(frame.cam_pose.astype(np.float64)).astype(np.float32)
        kf = Keyframe(
            fid=fid,
            camera=cam,
            t_cw=t_cw,
            image=image,
            mask=mask,
            created_at_iter=self.iteration,
            remaining_times_of_use=self.settings.new_keyframe_times_of_use,
        )
        if self.settings.do_gaus_pyramid_training:
            import cv2

            nl = self.settings.num_gaus_pyramid_sub_levels
            kf.pyramid_times_of_use = [self.settings.gaus_pyramid_sub_level_times_of_use] * nl
            for lvl in range(nl):
                f = 0.5 ** (nl - lvl)
                lw, lh = int(w * f), int(h * f)
                kf.pyramid_images.append(cv2.resize(image, (lw, lh)).astype(np.float32))
                if mask is not None:
                    # gaus_pyramid_undistort_mask_ (camera.h:103-105)
                    kf.pyramid_masks.append(
                        cv2.resize(mask, (lw, lh), interpolation=cv2.INTER_NEAREST).astype(np.float32)
                    )
        self.scene.add_keyframe(kf)
        self._upload_images(kf)
        self._kfid_shuffle = []  # re-shuffle on next sample

        pts = np.asarray(frame.points[: self.ingest_capacity], np.float32)
        cols = np.asarray(frame.colors[: self.ingest_capacity], np.float32)
        with self.timer.phase("ingest.increase_pcd"):
            if not self.initial_mapped:
                _, self.scene.cameras_extent = self.scene.nerfpp_norm()
                self.spatial_lr_scale = max(self.scene.cameras_extent, 1e-6)
                n_rest = (self.settings.model.sh_degree + 1) ** 2 - 1
                self.model = GaussianModel.create_from_pcd(pts, cols, n_rest=n_rest, device=self.device)
                self.adam = AdamState.init(self.model.params())
                self.initial_mapped = True
            else:
                increase_pcd(self.model, self.adam, pts, cols, iteration=self.iteration)
        self._invalidate_binning_caches()
        return kf

    def _undistorter(self, fx, fy, cx, cy, w, h, cam_model, dist):
        """The camera's UndistortRectifier, built once per geometry (the
        key is the geometry: the camera id is the frame id here)."""
        dist = np.asarray(dist, np.float64)
        key = (fx, fy, cx, cy, w, h, cam_model, dist.tobytes())
        und = self._undistorters.get(key)
        if und is None:
            from .camera_undistort import UndistortRectifier

            k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
            und = self._undistorters[key] = UndistortRectifier(k, dist, w, h, model=cam_model)
        return und

    def _upload_images(self, kf: Keyframe) -> None:
        """The keyframe's training images and masks, every level, to the
        device; the last level (num_gaus_pyramid_sub_levels) is full
        resolution. Timed as "upload.images"."""
        n_levels = self.settings.num_gaus_pyramid_sub_levels
        levels = [(n_levels, kf.image, kf.mask)]
        levels += [
            (lvl, img, kf.pyramid_masks[lvl] if kf.pyramid_masks else None)
            for lvl, img in enumerate(kf.pyramid_images)
        ]
        with self.timer.phase("upload.images"):
            for lvl, img, mask in levels:
                self._images[("gt", kf.fid, lvl)] = torch.as_tensor(img, dtype=torch.float32, device=self.device)
                if mask is not None:
                    self._images[("mask", kf.fid, lvl)] = torch.as_tensor(
                        mask, dtype=torch.float32, device=self.device
                    )

    def _invalidate_binning_caches(self, fid: int | None = None) -> None:
        """Drop frozen pair permutations: all of them on every live-set
        mutation (surgery, ingest, load), or, with `fid`, that keyframe's
        at every level, on its pose correction."""
        if fid is None:
            self._bin_cache.clear()
        else:
            for k in [k for k in self._bin_cache if k[0] == fid]:
                del self._bin_cache[k]

    # ------------------------------------------------------------- sampling
    def _use_one_random_sliding_window_keyframe(self) -> Keyframe | None:
        """useOneRandomSlidingWindowKeyframe (:526-575)."""
        kfs = self.scene.keyframes
        if not kfs:
            return None
        ids = sorted(kfs)
        if not self._kfid_shuffle:
            self._kfid_shuffle = list(range(len(ids)))
            self._rng.shuffle(self._kfid_shuffle)
            self._kfid_shuffle_idx = 0
        start = self._kfid_shuffle_idx
        while True:
            self._kfid_shuffle_idx = (self._kfid_shuffle_idx + 1) % len(self._kfid_shuffle)
            if self._kfid_shuffle_idx == start:
                for kf in kfs.values():
                    kf.remaining_times_of_use += 1
            kf = kfs[ids[self._kfid_shuffle[self._kfid_shuffle_idx]]]
            if kf.remaining_times_of_use > 0:
                break
        self.kfs_used_times[kf.fid] = self.kfs_used_times.get(kf.fid, 0) + 1
        kf.remaining_times_of_use -= 1
        return kf

    # ------------------------------------------------------------- training
    def _raster_cfg(self, h: int, w: int) -> RasterizeConfig:
        return RasterizeConfig(height=h, width=w, sh_degree=self.settings.model.sh_degree)

    @_traced
    def train_for_one_iteration(self) -> dict | None:
        """trainForOneIteration (:335-468) with the cadence on the host:
        sample a keyframe, take one step, run the cadence due at this
        iteration. Returns the step's loss, psnr, count and total_pairs, or
        None when there is nothing to train on.

        With metrics_pipeline_depth > 0 the returned metrics are the last
        resolved step's, up to that many steps old, and a placeholder with
        "pending": True before the first resolve; the in-flight steps are
        resolved before the cadence's surgery and when there is no keyframe
        to train on (the JAX mapper's contract).

        The mapper's first step, with the set-up that later steps do not
        pay, is timed as "mapper.first_step", around its "train_step"."""
        if not self.initial_mapped:
            return None
        first = self.iteration == 0
        with self.timer.phase("mapper.first_step") if first else contextlib.nullcontext():
            return self._train_one()

    def _train_one(self) -> dict | None:
        res = self._single_step_phase()
        if res is None:
            self.flush_metrics()
            return None
        if res is _PENDING:
            if self._cadence_due(self.iteration):
                self.flush_metrics()
                self._cadence_phase(self.iteration)
            if self._last_resolved is not None:
                return self._last_resolved
            return {"loss": float("nan"), "psnr": float("nan"), "count": -1, "total_pairs": -1, "pending": True}
        self._cadence_phase(self.iteration)
        return self._consume_metrics(res)

    def _single_step_phase(self):
        kf = self._use_one_random_sliding_window_keyframe()
        if kf is None:
            return None
        self.iteration += 1
        s = self.settings
        n_levels = s.num_gaus_pyramid_sub_levels
        level = n_levels
        if s.do_gaus_pyramid_training:
            level = kf.current_pyramid_level()
        if level >= n_levels or not kf.pyramid_images:
            level = n_levels
        h, w = self._images[("gt", kf.fid, level)].shape[:2]
        self._last_kf = kf
        depth = int(s.metrics_pipeline_depth)
        if depth <= 0:
            self.flush_metrics()  # a depth lowered while steps were in flight
        rec = self._dispatch_train_step(kf, level, h, w, self.iteration, pipelined=depth > 0)
        self._commit_bin_cache(rec)
        if depth <= 0:
            # the reference's semantics: it reads loss.item() every
            # iteration (gaussian_mapper.cpp:437)
            return rec
        self._pending.append(rec)
        while len(self._pending) > depth:
            self._consume_metrics(self._resolve(self._pending.pop(0)))
        return _PENDING

    def _dispatch_train_step(self, kf: Keyframe, level: int, h: int, w: int, iteration: int,
                             pipelined: bool = False) -> dict:
        """The cache decision and one train_step. Synchronous, it reads the
        loss and PSNR with one `.tolist()` (the pair count is a host tensor:
        the binning's own read-back), and the "train_step" phase runs from
        the call to that read, so to the device's completion of the step.
        `pipelined`, it copies them with non_blocking=True into a pinned
        host buffer of this step's own and records a CUDA event after the
        copy (on the CPU the pair itself is kept), for `_resolve`; the
        phase then ends at the dispatch."""
        s = self.settings
        rk = (kf.fid, level)
        # Cross-step binning persistence (JAX :771-797): reuse this
        # (keyframe, level)'s pruned pair permutation for up to rebin - 1
        # renders while the model (count and generation) and the image size
        # are those it was built for; export a new one otherwise.
        use_cache, export_cache = None, False
        rebin = s.rebin_interval
        if s.rebin_interval_after_densify and iteration >= s.opt.densify_until_iter:
            # staged persistence: after densification the set is frozen
            rebin = s.rebin_interval_after_densify
        if rebin > 1:
            ent = self._bin_cache.get(rk)
            if (
                ent is not None
                and ent["uses"] < rebin - 1
                and ent["count"] == self.model.count
                and ent["generation"] == self.model.generation
                and ent["hw"] == (h, w)
            ):
                use_cache = ent["cache"]
            else:
                export_cache = True
        binning = "cached" if use_cache is not None else ("export" if export_cache else "fresh")

        gt = self._images[("gt", kf.fid, level)]
        mask = self._images.get(("mask", kf.fid, level))
        rec = {"rk": rk, "hw": (h, w), "binning": binning, "iteration": iteration, "kf": kf}
        with self.timer.phase("train_step"):
            res = train_step(
                self.model,
                self.adam,
                kf.camera_matrices(s.z_near, s.z_far, device=self.device),
                gt,
                mask,
                self._bg[bool(s.model.white_background)],
                iteration,
                self.spatial_lr_scale,
                self._raster_cfg(h, w),
                s.opt,
                accumulate_stats=iteration < s.opt.densify_until_iter,
                active_sh_degree=self.active_sh_degree,
                binning_cache=use_cache,
                export_binning_cache=export_cache,
            )
            metrics, rec["built_cache"] = res if export_cache else (res, None)
            pair = torch.stack([metrics.loss, metrics.psnr])
            with self.timer.phase("step.readback"):
                if not pipelined:
                    rec["loss"], rec["psnr"] = pair.tolist()
                elif pair.is_cuda:
                    rec["host"] = torch.empty(2, dtype=torch.float32, pin_memory=True)
                    rec["host"].copy_(pair, non_blocking=True)
                    rec["event"] = torch.cuda.Event()
                    rec["event"].record()
                else:
                    rec["host"] = pair
        rec["count"], rec["total_pairs"] = metrics.count, int(metrics.total_pairs)
        self.last_binning = binning
        self.binning_counts[binning] += 1
        return rec

    @staticmethod
    def _resolve(rec: dict) -> dict:
        """An in-flight step's loss and PSNR, read from its host buffer once
        its event has passed."""
        if "event" in rec:
            rec.pop("event").synchronize()
        rec["loss"], rec["psnr"] = rec.pop("host").tolist()
        return rec

    def flush_metrics(self) -> None:
        """Resolve every in-flight step, in order (metrics_pipeline_depth):
        before the cadence's surgery, pose corrections, checkpoints and the
        PLY save and load, and at the end of `run()`."""
        while self._pending:
            self._consume_metrics(self._resolve(self._pending.pop(0)))

    def _commit_bin_cache(self, rec: dict) -> None:
        if rec["binning"] == "export":
            self._bin_cache[rec["rk"]] = {
                "cache": rec["built_cache"],
                "uses": 0,
                "count": self.model.count,
                "generation": self.model.generation,
                "hw": rec["hw"],
            }
            while len(self._bin_cache) > MAX_BIN_CACHES:  # bound the memory held by caches
                self._bin_cache.pop(next(iter(self._bin_cache)))
        elif rec["binning"] == "cached":
            self._bin_cache[rec["rk"]]["uses"] += 1

    def _cadence_due(self, iteration: int) -> bool:
        """Would _cadence_phase mutate state at this iteration?"""
        s = self.settings
        if iteration >= s.opt.densify_until_iter:
            return False
        if (
            iteration > s.opt.densify_from_iter
            and s.opt.densification_interval
            and iteration % s.opt.densification_interval == 0
        ):
            return True
        return bool(
            (s.opt.opacity_reset_interval and iteration % s.opt.opacity_reset_interval == 0)
            or (s.model.white_background and iteration == s.opt.densify_from_iter)
        )

    def _cadence_phase(self, iteration: int) -> None:
        """State-mutating per-iteration cadence: densify/prune surgery and
        opacity reset (trainForOneIteration :449-461). Depends only on the
        iteration number, never on that step's metrics; timed as "cadence"
        where it runs."""
        if not self._cadence_due(iteration):
            return
        s = self.settings
        with self.timer.phase("cadence"):
            if (
                iteration > s.opt.densify_from_iter
                and s.opt.densification_interval
                and iteration % s.opt.densification_interval == 0
            ):
                densify_and_prune(
                    self.model,
                    self.adam,
                    max_grad=s.opt.densify_grad_threshold,
                    min_opacity=s.densify_min_opacity,
                    extent=self.scene.cameras_extent,
                    max_screen_size=20 if iteration > s.prune_big_point_after_iter else 0,
                    percent_dense=s.opt.percent_dense,
                    generator=self._generator,
                )
                self._invalidate_binning_caches()
            # resetOpacity cadence (gaussian_mapper.cpp:460): also fires for
            # white-background runs exactly when iteration == densify_from.
            if (s.opt.opacity_reset_interval and iteration % s.opt.opacity_reset_interval == 0) or (
                s.model.white_background and iteration == s.opt.densify_from_iter
            ):
                reset_opacity(self.model, self.adam)
                self._invalidate_binning_caches()

    def _consume_metrics(self, rec: dict) -> dict:
        """Metrics-side post-step work for a step with its loss read: the
        loss EMA, the report, the keyframe image record and the step log.
        At once when synchronous; at resolve time, in step order, when
        pipelined."""
        s = self.settings
        it, loss = rec["iteration"], rec["loss"]
        self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
        if s.training_report_interval and it % s.training_report_interval == 0:
            print(
                f"[mapper] iter {it}: ema_loss {self.ema_loss:.5f} points {rec['count']} pairs "
                f"{rec['total_pairs']} [{self.timer.report()}]"
            )
        if self.result_dir and s.keyframe_record_interval and it % s.keyframe_record_interval == 0:
            self._record_keyframe_images(rec["kf"])
        if self.step_log is not None:
            self.step_log.append({"iteration": it, "fid": rec["kf"].fid, "binning": rec["binning"],
                                  "count": int(rec["count"]), "loss": loss, "psnr": rec["psnr"]})
        self._last_resolved = {"loss": loss, "psnr": rec["psnr"], "count": int(rec["count"]),
                               "total_pairs": int(rec["total_pairs"])}
        return self._last_resolved

    # ------------------------------------------------------- SLAM-mode feed
    @_traced
    def feed_keyframe(
        self,
        fid: int,
        t_wc: np.ndarray,
        image: np.ndarray,
        points: np.ndarray | None = None,
        colors: np.ndarray | None = None,
        depth: np.ndarray | None = None,
        intrinsics=None,
    ) -> Keyframe:
        """Tracking-fed keyframe ingestion (Photo-SLAM operating mode): a
        host-side tracker pushes a pose, an image, and either a sparse
        map-point cloud, an RGB-D depth image, which is backprojected at a
        stride of 4 ("ingest.backproject"), or nothing for pure monocular.
        A keyframe with no depth, while do_inactive_geo_densify is set,
        then goes through the monocular inactive-geometry densify. Returns
        the registered keyframe; call train_for_one_iteration() to
        optimize."""
        is_mono = depth is None
        if intrinsics is not None:
            self._feed_intrinsics = intrinsics
        if points is not None and len(points):
            # tracker map points: accumulate for input.ply
            # (saveSparsePointsPly, gaussian_model.cpp:955-996)
            self.sparse_points_xyz.append(np.asarray(points, np.float32))
            self.sparse_points_color.append(
                np.asarray(colors, np.float32)
                if colors is not None
                else np.zeros_like(np.asarray(points, np.float32))
            )
        if depth is not None and points is None:
            with self.timer.phase("ingest.backproject"):
                points, colors = self._backproject(t_wc, image, depth, intrinsics)
        if points is None:
            points = np.zeros((0, 3), np.float32)
            colors = np.zeros((0, 3), np.float32)
        frame = FrameData(
            cam_pose=np.asarray(t_wc, np.float32),
            points=points,
            colors=colors if colors is not None else np.zeros_like(points),
            image=np.asarray(image, np.float32),
        )
        kf = self.ingest_frame(fid, frame)
        if is_mono and self.settings.do_inactive_geo_densify:
            self._inactive_geo_densify(kf, sparse_world=points if len(points) else None)
        return kf

    def _backproject(self, t_wc, image, depth, intrinsics):
        """World points and colours of an RGB-D frame at a stride of 4;
        through the distortion model when the camera has one, so that the
        seed cloud projects consistently onto the undistorted training
        image (UndistortRectifier.backproject_depth), with colours from the
        raw image at the raw pixels."""
        from ..data.replica import backproject_depth

        intr = intrinsics or self._intr_from_image(image)
        dist_raw = getattr(intr, "dist", None)
        dist = np.asarray(() if dist_raw is None else dist_raw)
        if dist.size and np.any(dist != 0):
            h0, w0 = depth.shape[:2]
            und = self._undistorter(
                intr.fx, intr.fy, intr.cx, intr.cy, w0, h0, getattr(intr, "model", "pinhole"), dist
            )
            pts_cam = und.backproject_depth(depth, stride=4)
        else:
            pts_cam = backproject_depth(depth, intr, stride=4)
        t = np.asarray(t_wc, np.float64)
        points = (pts_cam @ t[:3, :3].T + t[:3, 3]).astype(np.float32)
        ys, xs = np.meshgrid(np.arange(0, depth.shape[0], 4), np.arange(0, depth.shape[1], 4), indexing="ij")
        colors = image[ys, xs][depth[ys, xs] > 0].astype(np.float32)
        return points, colors

    def _intr_from_image(self, image: np.ndarray):
        from ..data import CameraIntrinsics

        cam0 = next(iter(self.scene.cameras.values()), None)
        h, w = image.shape[:2]
        if cam0 is not None:
            return CameraIntrinsics(cam0.fx, cam0.fy, cam0.cx, cam0.cy, w, h)
        return CameraIntrinsics(w / 2.0, w / 2.0, (w - 1) / 2.0, (h - 1) / 2.0, w, h)

    # ----------------------------------------- inactive-geometry densify
    def _inactive_geo_densify(self, kf: Keyframe, sparse_world: np.ndarray | None = None) -> None:
        """Monocular inactive-geometry densification (the JAX mapper's
        reconstruction of the members include/gaussian_mapper.h:252-262):
        depths for a grid of samples of the keyframe, at a stride of
        max(4, min(h, w) // 60), from

          (a) the nearest projected tracker point within
              inactive_geo_densify_max_pixel_dist ("mono.nearest": float64
              numpy on the host, the first index of the least squared
              distance),
          (b) else the map's depth render where its coverage is over 0.5
              and its depth over 0.2 ("mono.depth_render": K3 and K1 on
              the card, gathered at the samples there; only those values
              come back to the host),
          (c) else, where no sample has a depth at all, the flat prior
              monocular_init_depth,

        backprojected into the world and cached; every max_depth_cached
        keyframes the cache goes through increase_pcd in chunks of
        ingest_capacity rows ("mono.increase_pcd"), whose voxel dedup
        drops re-observations."""
        s = self.settings
        h, w = kf.image.shape[:2]
        stride = max(4, min(h, w) // 60)
        ys, xs = np.mgrid[stride // 2 : h : stride, stride // 2 : w : stride]
        gy = ys.reshape(-1).astype(np.int64)
        gx = xs.reshape(-1).astype(np.int64)
        depth = np.full(gy.shape, np.nan, np.float32)
        source = np.full(gy.shape, -1, np.int8)
        rendered = np.full((2, len(gy)), np.nan, np.float32)
        cam = kf.camera

        if sparse_world is not None and len(sparse_world):
            with self.timer.phase("mono.nearest"):
                t = kf.t_cw.astype(np.float64)
                pc = np.asarray(sparse_world, np.float64) @ t[:3, :3].T + t[:3, 3]
                z = pc[:, 2]
                ok = z > 0.2
                with np.errstate(divide="ignore", invalid="ignore"):
                    u = cam.fx * pc[:, 0] / z + cam.cx
                    v = cam.fy * pc[:, 1] / z + cam.cy
                ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
                su, sv, sz = u[ok], v[ok], z[ok]
                if len(sz):
                    d2 = (gx[:, None] - su[None, :]) ** 2 + (gy[:, None] - sv[None, :]) ** 2
                    j = np.argmin(d2, axis=1)
                    near = d2[np.arange(len(gx)), j] <= s.inactive_geo_densify_max_pixel_dist**2
                    depth[near] = sz[j[near]].astype(np.float32)
                    source[near] = MONO_SOURCES.index("tracker")

        todo = ~np.isfinite(depth)
        if np.any(todo) and self.initial_mapped and self.model.count > 0:
            with self.timer.phase("mono.depth_render"):
                dep, cov = render_depth_state(
                    self.model, kf.camera_matrices(s.z_near, s.z_far, device=self.device), self._raster_cfg(h, w)
                )
                flat = torch.as_tensor(gy[todo] * w + gx[todo], device=self.device)
                rendered[:, todo] = torch.stack([dep.reshape(-1), cov.reshape(-1)])[:, flat].cpu().numpy()
            dsel, csel = rendered[:, todo]
            good = (csel > 0.5) & (dsel > 0.2)
            idx = np.where(todo)[0][good]
            depth[idx] = dsel[good]
            source[idx] = MONO_SOURCES.index("render")

        if not np.any(np.isfinite(depth)):
            depth[:] = s.monocular_init_depth
            source[:] = MONO_SOURCES.index("prior")

        ok = np.isfinite(depth) & (depth > 0.2)
        source[~ok] = -1
        self.last_mono_samples = {"gy": gy, "gx": gx, "depth": np.where(ok, depth, np.nan), "source": source,
                                  "rendered_depth": rendered[0], "coverage": rendered[1]}
        if not np.any(ok):
            return
        zc = depth[ok].astype(np.float64)
        xc = (gx[ok] - cam.cx) / cam.fx * zc
        yc = (gy[ok] - cam.cy) / cam.fy * zc
        pts_cam = np.stack([xc, yc, zc], axis=-1)
        c2w = np.linalg.inv(kf.t_cw.astype(np.float64))
        pts_w = (pts_cam @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)

        self.depth_cache_points.append(pts_w)
        self.depth_cache_colors.append(kf.image[gy[ok], gx[ok]].astype(np.float32))
        self.mono_sources.update(MONO_SOURCES[c] for c in source[ok])
        self.depth_cached += 1
        if self.depth_cached >= max(1, s.max_depth_cached):
            pts = np.concatenate(self.depth_cache_points, axis=0)
            cols = np.concatenate(self.depth_cache_colors, axis=0)
            self.depth_cache_points, self.depth_cache_colors = [], []
            self.depth_cached = 0
            self._ingest_points(pts, cols)

    def _ingest_points(self, points: np.ndarray, colors: np.ndarray) -> None:
        """Grow the model from host arrays in chunks of ingest_capacity rows
        (the JAX mapper's padded ingest buffer): each chunk's voxel dedup
        sees the rows the chunks before it appended, and its 3-NN scales
        only its own kept points, so the chunking is part of the result."""
        with self.timer.phase("mono.increase_pcd"):
            for i in range(0, len(points), self.ingest_capacity):
                increase_pcd(
                    self.model, self.adam, points[i : i + self.ingest_capacity],
                    colors[i : i + self.ingest_capacity], iteration=self.iteration,
                )
        self._invalidate_binning_caches()

    # ------------------------------------------------ tracker pose updates
    def update_keyframe_pose(self, fid: int, t_wc: np.ndarray) -> None:
        """A tracker pose correction (local BA, loop closure) of keyframe
        `fid`: its t_cw and its camera matrices are replaced and its binning
        caches dropped. A correction over large_rotation_threshold degrees
        or large_translation_threshold metres (large_rot_th_ /
        large_trans_th_, gaussian_mapper.cpp:17-18) then prunes the
        Gaussians too young to be stable (`on_large_pose_change`). Unknown
        keyframes are ignored. Resolves the steps in flight first."""
        kf = self.scene.keyframes.get(fid)
        if kf is None:
            return
        self.flush_metrics()
        new_tcw = np.linalg.inv(np.asarray(t_wc, np.float64)).astype(np.float32)
        rel_r = new_tcw[:3, :3].astype(np.float64) @ kf.t_cw[:3, :3].astype(np.float64).T
        ang_deg = math.degrees(rotation_angle(rel_r))
        dtr = float(np.linalg.norm(
            np.asarray(t_wc, np.float64)[:3, 3] - np.linalg.inv(kf.t_cw.astype(np.float64))[:3, 3]
        ))
        kf.t_cw = new_tcw
        kf._cam_matrices = None  # the images do not depend on the pose
        self._invalidate_binning_caches(fid)
        s = self.settings
        if ang_deg > s.large_rotation_threshold or dtr > s.large_translation_threshold:
            self.on_large_pose_change()

    def on_large_pose_change(self) -> None:
        """Existence pruning after a large pose correction: the Gaussians
        with exist_since_iter > iteration - stable_num_iter_existence were
        trained against poses that just moved and are dropped
        (include/gaussian_mapper.h:275); 0 disables it. A prune starts a
        new generation, so every binning cache goes."""
        s = self.settings
        if s.stable_num_iter_existence > 0 and self.initial_mapped:
            self.flush_metrics()
            prune_young(self.model, self.adam, self.iteration, s.stable_num_iter_existence)
            self._invalidate_binning_caches()

    # ----------------------------------------------- live parameter channel
    def get_variable_parameters(self) -> VariableParameters:
        """getVaribleParameters (gaussian_mapper.cpp:941-960)."""
        s = self.settings
        return VariableParameters(
            position_lr_init=s.opt.position_lr_init,
            feature_lr=s.opt.feature_lr,
            opacity_lr=s.opt.opacity_lr,
            scaling_lr=s.opt.scaling_lr,
            rotation_lr=s.opt.rotation_lr,
            percent_dense=s.opt.percent_dense,
            lambda_dssim=s.opt.lambda_dssim,
            opacity_reset_interval=s.opt.opacity_reset_interval,
            densify_grad_th=s.opt.densify_grad_threshold,
            densify_interval=s.opt.densification_interval,
            new_kf_times_of_use=s.new_keyframe_times_of_use,
            keep_training=not self._stopped,
            do_gaus_pyramid_training=s.do_gaus_pyramid_training,
            do_inactive_geo_densify=s.do_inactive_geo_densify,
            stable_num_iter_existence=s.stable_num_iter_existence,
        )

    def set_variable_parameters(self, p: VariableParameters) -> None:
        """setVaribleParameters (gaussian_mapper.cpp:962-982): the next step
        reads the new values (train_step takes them as plain floats);
        keep_training=False stops `run()`."""
        s = self.settings
        self.settings = dataclasses.replace(
            s,
            opt=dataclasses.replace(
                s.opt,
                position_lr_init=p.position_lr_init,
                feature_lr=p.feature_lr,
                opacity_lr=p.opacity_lr,
                scaling_lr=p.scaling_lr,
                rotation_lr=p.rotation_lr,
                percent_dense=p.percent_dense,
                lambda_dssim=p.lambda_dssim,
                opacity_reset_interval=p.opacity_reset_interval,
                densify_grad_threshold=p.densify_grad_th,
                densification_interval=p.densify_interval,
            ),
            new_keyframe_times_of_use=p.new_kf_times_of_use,
            do_gaus_pyramid_training=p.do_gaus_pyramid_training,
            do_inactive_geo_densify=p.do_inactive_geo_densify,
            stable_num_iter_existence=p.stable_num_iter_existence,
        )
        if not p.keep_training:
            self.signal_stop()

    # ---------------------------------------------------------- checkpoints
    def save_checkpoint(self, path: str | Path) -> None:
        """A full training checkpoint (parameters, statistics, Adam moments
        and step, the iteration), in the JAX package's `.npz` keys:
        state.*, adam.m.*, adam.v.*, adam.step, iteration,
        spatial_lr_scale, cameras_extent. The rows are the live ones, with
        state.count equal to them; the JAX loader reads such a file, and
        the JAX package's own pair-capacity keys are not written. Resolves
        the steps in flight first."""
        self.flush_metrics()
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        host = lambda t: t.detach().cpu().numpy()
        m, adam = self.model, self.adam
        blobs = {f"state.{k}": host(v) for k, v in m.params().items()}
        blobs.update({f"state.{k}": host(getattr(m, k)) for k in STATS})
        blobs.update({f"adam.m.{k}": host(v) for k, v in adam.m.items()})
        blobs.update({f"adam.v.{k}": host(v) for k, v in adam.v.items()})
        blobs.update({
            "state.count": np.asarray(m.count, np.int32),
            "adam.step": np.asarray(adam.step, np.int32),
            "iteration": np.asarray(self.iteration),
            "spatial_lr_scale": np.asarray(self.spatial_lr_scale),
            "cameras_extent": np.asarray(self.scene.cameras_extent),
        })
        np.savez_compressed(path, **blobs)

    def load_checkpoint(self, path: str | Path) -> None:
        """Restore a checkpoint of either package onto the mapper's device:
        the first state.count rows (a JAX checkpoint's rows are padded to
        its capacity). The model starts a new generation and every binning
        cache is dropped. Resolves the steps in flight first."""
        self.flush_metrics()
        with np.load(path) as z:
            n = int(z["state.count"])
            rows = lambda k: torch.as_tensor(z[k][:n], device=self.device)
            model = GaussianModel({k: rows(f"state.{k}") for k in PARAM_GROUPS})
            for k in STATS:
                setattr(model, k, rows(f"state.{k}").to(getattr(model, k).dtype))
            self.adam = AdamState(
                m={k: rows(f"adam.m.{k}").to(torch.float32) for k in PARAM_GROUPS},
                v={k: rows(f"adam.v.{k}").to(torch.float32) for k in PARAM_GROUPS},
                step=int(z["adam.step"]),
            )
            self.iteration = int(z["iteration"])
            self.spatial_lr_scale = float(z["spatial_lr_scale"])
            self.scene.cameras_extent = float(z["cameras_extent"])
        model.generation = self.model.generation + 1 if self.model is not None else 0
        self.model = model
        self.initial_mapped = True
        self._invalidate_binning_caches()

    # ---------------------------------------------------------- SH degree
    def set_sh_degree(self, degree: int | None) -> None:
        """setShDegree (gaussian_model.cpp:109-112); None = max degree."""
        if degree is not None:
            degree = min(degree, self.settings.model.sh_degree)
        self.active_sh_degree = degree

    def one_up_sh_degree(self) -> None:
        """oneUpShDegree (gaussian_model.cpp:103-107)."""
        cur = self.active_sh_degree
        if cur is None:
            return
        self.active_sh_degree = min(cur + 1, self.settings.model.sh_degree)

    # ------------------------------------------------------------ rendering
    @torch.no_grad()
    def render_from_pose(self, t_cw: np.ndarray, width: int, height: int, fovx=None, fovy=None) -> np.ndarray:
        """renderFromPose (:608-657) for viewers and evaluation: [H, W, 3]."""
        cam0 = next(iter(self.scene.cameras.values()), None)
        if fovx is None:
            fovx = cam0.fovx if cam0 else math.pi / 2
        if fovy is None:
            fovy = cam0.fovy if cam0 else math.pi / 2
        q = rot_to_quat_wxyz(t_cw[:3, :3])
        cm = CameraMatrices.from_pose(
            q, t_cw[:3, 3], fovx, fovy, self.settings.z_near, self.settings.z_far, device=self.device
        )
        bg = self._bg[bool(self.settings.model.white_background)]
        out = render_state(self.model, cm, bg, self._raster_cfg(height, width))
        return out.image.cpu().numpy()

    # -------------------------------------------------------------- results
    def save_ply(self, out_dir: str | Path | None = None) -> Path:
        """savePly (:659-755): point_cloud/iteration_N/point_cloud.ply +
        cameras.json + cfg_args, 3DGS-viewer compatible, and the
        keyframe_used_times file. Resolves the steps in flight first."""
        self.flush_metrics()
        base = Path(out_dir or self.result_dir)
        it_dir = base / "point_cloud" / f"iteration_{self.iteration}"
        write_ply(it_dir / "point_cloud.ply", gaussians_to_ply_dict(self.model))

        cams = []
        for kf in self.scene.keyframes.values():
            c2w = np.linalg.inv(kf.t_cw.astype(np.float64))
            cams.append(
                {
                    "id": kf.fid,
                    "img_name": str(kf.fid),
                    "width": kf.camera.width,
                    "height": kf.camera.height,
                    "position": c2w[:3, 3].tolist(),
                    "rotation": c2w[:3, :3].tolist(),
                    "fx": kf.camera.fx,
                    "fy": kf.camera.fy,
                }
            )
        base.mkdir(parents=True, exist_ok=True)
        if self.sparse_points_xyz:
            write_sparse_points_ply(
                base / "input.ply",
                np.concatenate(self.sparse_points_xyz, axis=0),
                np.concatenate(self.sparse_points_color, axis=0),
            )
        (base / "cameras.json").write_text(json.dumps(cams))
        (base / "cfg_args").write_text(
            "Namespace(eval=False, images='images', model_path='{}', "
            "resolution=-1, sh_degree={}, source_path='', white_background={})".format(
                base, self.settings.model.sh_degree, self.settings.model.white_background,
            )
        )
        self._write_keyframe_used_times(base)
        return it_dir / "point_cloud.ply"

    def _record_keyframe_images(self, kf: Keyframe) -> None:
        """Record.keyframe_record_interval: the render of keyframe `kf`'s
        view and its gt image, as record/iter{N}_kf{fid}_{rendered,gt}.png
        under result_dir (N the mapper's iteration when written, as in the
        JAX package); cv2 imported here."""
        import cv2

        out = Path(self.result_dir) / "record"
        out.mkdir(parents=True, exist_ok=True)
        img = self.render_from_pose(kf.t_cw, kf.camera.width, kf.camera.height, kf.camera.fovx, kf.camera.fovy)
        for name, arr in (("rendered", img), ("gt", kf.image)):
            cv2.imwrite(
                str(out / f"iter{self.iteration}_kf{kf.fid}_{name}.png"),
                cv2.cvtColor((np.clip(arr, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR),
            )

    def _write_keyframe_used_times(self, base: Path) -> None:
        """keyframe_used_times log (:757-775)."""
        lines = [f"{fid} {times}" for fid, times in sorted(self.kfs_used_times.items())]
        (base / f"keyframe_used_times_{self.iteration}.txt").write_text("\n".join(lines) + "\n")

    def load_ply(self, ply_path: str | Path) -> None:
        """loadPly (:984-1059): a view-only restore (no optimizer state,
        like the reference), on the mapper's device. Resolves the steps in
        flight first."""
        self.flush_metrics()
        self.model = ply_dict_to_gaussians(read_ply(ply_path), device=self.device)
        self.adam = AdamState.init(self.model.params())
        self.initial_mapped = True
        self._invalidate_binning_caches()
