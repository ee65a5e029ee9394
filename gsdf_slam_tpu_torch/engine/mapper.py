"""GaussianMapper: the streaming training loop, synchronous, on one device.

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
    generation and the image size are those it was built for, and every
    surgery drops them all;
  * a precomputed sky mask and camera undistortion (:172-275);
  * results: 3DGS-format PLY + cameras.json + cfg_args (:659-775).

Training images are held as tensors on the mapper's device (the card
unless told otherwise). Each step reads its loss and PSNR with one
`.tolist()`; its pair count is already on the host. The map is sized to
its live Gaussians and the pairs exactly, so the JAX package's
capacities, pair autosizing, overflow redo loops, compile prewarm and
device-scalar caches have no counterpart here.

Not ported yet; each raises NotImplementedError naming its ROADMAP item:
the pipelined metrics (`metrics_pipeline_depth > 0`), the multi-device
`mesh`, live sky segmentation (`skyseg_onnx_path`), the monocular
inactive-geometry densify, tracker pose updates, checkpoints, the live
parameter channel and keyframe image recording.
"""

from __future__ import annotations

import json
import math
import random
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..data.loader import DataLoader, FrameData
from ..io.ply import gaussians_to_ply_dict, ply_dict_to_gaussians, read_ply, write_ply, write_sparse_points_ply
from ..models.gaussian_model import GaussianModel, densify_and_prune, increase_pcd, reset_opacity
from ..models.optimizer import AdamState
from ..ops.rasterize import RasterizeConfig
from ..ops.transforms import CameraMatrices
from ..utils.observability import PhaseTimer
from .keyframe import Camera, Keyframe, rot_to_quat_wxyz
from .scene import Scene
from .settings import MapperSettings
from .train import render_state, train_step

# the most binning caches held at once (the JAX mapper's bound, :925)
MAX_BIN_CACHES = 32


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to gsdf_slam_tpu_torch yet (ROADMAP {item})")


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
        if self.settings.metrics_pipeline_depth > 0:
            raise _not_ported("pipelined metrics (metrics_pipeline_depth > 0)", "A2b.1")
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
        # setShDegree/oneUpShDegree (gaussian_model.cpp:103-112); None is
        # the max degree, which the reference's run() forces (:375)
        self.active_sh_degree: int | None = None
        # tracker points for input.ply (saveSparsePointsPly,
        # gaussian_model.cpp:955-996)
        self.sparse_points_xyz: list[np.ndarray] = []
        self.sparse_points_color: list[np.ndarray] = []
        # per-camera undistortion (gaussian_mapper.cpp:172-204), built at
        # ingest when distortion is present
        self._undistorters: dict[tuple, object] = {}
        self._feed_intrinsics = None  # intrinsics passed with a frame
        self.timer = PhaseTimer()

    # ------------------------------------------------------------------ run
    def run(self) -> None:
        """Streaming mapping over the whole dataset (run(), :160-333)."""
        assert self.dataloader is not None, "run() needs a dataloader"
        for i in range(len(self.dataloader)):
            if self._stopped:
                break
            self.ingest_frame(i, self.dataloader.get_item(i))
            self.train_for_one_iteration()

    def signal_stop(self) -> None:
        self._stopped = True

    # --------------------------------------------------------------- ingest
    def ingest_frame(self, fid: int, frame: FrameData, intrinsics=None) -> Keyframe:
        """Register camera and keyframe and grow the model from the frame's
        cloud, of which the first `ingest_capacity` points are used.
        `intrinsics` (a CameraIntrinsics), if given, is kept for this and
        later frames; else the dataloader's, else a 90-degree camera."""
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
                self.model = GaussianModel.create_from_pcd(
                    pts, cols, n_rest=n_rest, device=self.device, timer=self.timer
                )
                self.adam = AdamState.init(self.model.params())
                self.initial_mapped = True
            else:
                increase_pcd(self.model, self.adam, pts, cols, iteration=self.iteration, timer=self.timer)
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
        resolution."""
        n_levels = self.settings.num_gaus_pyramid_sub_levels
        levels = [(n_levels, kf.image, kf.mask)]
        levels += [
            (lvl, img, kf.pyramid_masks[lvl] if kf.pyramid_masks else None)
            for lvl, img in enumerate(kf.pyramid_images)
        ]
        for lvl, img, mask in levels:
            self._images[("gt", kf.fid, lvl)] = torch.as_tensor(img, dtype=torch.float32, device=self.device)
            if mask is not None:
                self._images[("mask", kf.fid, lvl)] = torch.as_tensor(mask, dtype=torch.float32, device=self.device)

    def _invalidate_binning_caches(self) -> None:
        """Drop every frozen pair permutation: called on every live-set
        mutation (surgery, ingest, load)."""
        self._bin_cache.clear()

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

    def train_for_one_iteration(self) -> dict | None:
        """trainForOneIteration (:335-468) with the cadence on the host:
        sample a keyframe, take one step, run the cadence due at this
        iteration. Returns the step's loss, psnr, count and total_pairs, or
        None when there is nothing to train on."""
        if not self.initial_mapped:
            return None
        res = self._single_step_phase()
        if res is None:
            return None
        self._cadence_phase(self.iteration)
        return self._consume_metrics(self.iteration, *res)

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
        return self._sync_step(kf, level, h, w, self.iteration)

    def _sync_step(self, kf: Keyframe, level: int, h: int, w: int, iteration: int):
        """One step and its blocking metrics read, depth 0 (the
        reference's semantics: it reads loss.item() every iteration,
        gaussian_mapper.cpp:437). Returns (loss, psnr, count, total_pairs)."""
        rec = self._dispatch_train_step(kf, level, h, w, iteration)
        self._commit_bin_cache(rec)
        return rec["loss"], rec["psnr"], rec["count"], rec["total_pairs"]

    def _dispatch_train_step(self, kf: Keyframe, level: int, h: int, w: int, iteration: int) -> dict:
        """The cache decision, one train_step and its loss and PSNR, read
        with one `.tolist()` (the pair count is a host tensor: the
        binning's own read-back); the "train_step" phase runs from the call
        to that read, so to the device's completion of the step."""
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
            metrics, built_cache = res if export_cache else (res, None)
            loss, psnr_v = torch.stack([metrics.loss, metrics.psnr]).tolist()
        self.last_binning = binning
        self.binning_counts[binning] += 1
        return {
            "rk": rk, "hw": (h, w), "binning": binning, "built_cache": built_cache,
            "loss": loss, "psnr": psnr_v, "count": metrics.count, "total_pairs": int(metrics.total_pairs),
        }

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

    def _consume_metrics(self, iteration, loss, psnr_v, count_v, total_pairs) -> dict:
        """Metrics-side post-step work: the loss EMA, the report and the
        keyframe image record."""
        s = self.settings
        self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
        if s.training_report_interval and iteration % s.training_report_interval == 0:
            print(
                f"[mapper] iter {iteration}: ema_loss {self.ema_loss:.5f} points {count_v} pairs "
                f"{total_pairs} [{self.timer.report()}]"
            )
        if self.result_dir and s.keyframe_record_interval and iteration % s.keyframe_record_interval == 0:
            self._record_keyframe_images(self._last_kf)
        return {"loss": loss, "psnr": psnr_v, "count": int(count_v), "total_pairs": int(total_pairs)}

    # ------------------------------------------------------- SLAM-mode feed
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
        map-point cloud or an RGB-D depth image, which is backprojected at
        a stride of 4 ("ingest.backproject"). Returns the registered
        keyframe; call train_for_one_iteration() to optimize. A keyframe
        with no depth while do_inactive_geo_densify is set needs the
        monocular densify, which is not ported yet."""
        if depth is None and self.settings.do_inactive_geo_densify:
            raise _not_ported("the monocular inactive-geometry densify (do_inactive_geo_densify)", "A2b.2")
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
        return self.ingest_frame(fid, frame)

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

    # ------------------------------------------------- not ported yet
    def update_keyframe_pose(self, fid: int, t_wc: np.ndarray) -> None:
        """Tracker pose correction (local BA / loop closure)."""
        raise _not_ported("update_keyframe_pose", "A2b.3")

    def on_large_pose_change(self) -> None:
        """Existence pruning after a big pose update."""
        raise _not_ported("on_large_pose_change", "A2b.3")

    def save_checkpoint(self, path: str | Path) -> None:
        raise _not_ported("save_checkpoint", "A2b.4")

    def load_checkpoint(self, path: str | Path) -> None:
        raise _not_ported("load_checkpoint", "A2b.4")

    def get_variable_parameters(self):
        """getVaribleParameters (gaussian_mapper.cpp:941-960)."""
        raise _not_ported("get_variable_parameters", "A2b.5")

    def set_variable_parameters(self, p) -> None:
        """setVaribleParameters (gaussian_mapper.cpp:962-982)."""
        raise _not_ported("set_variable_parameters", "A2b.5")

    def _record_keyframe_images(self, kf: Keyframe) -> None:
        """Record.keyframe_record_interval: rendered and gt images."""
        raise _not_ported("keyframe image recording (keyframe_record_interval)", "A2b.6")

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
        keyframe_used_times file."""
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

    def _write_keyframe_used_times(self, base: Path) -> None:
        """keyframe_used_times log (:757-775)."""
        lines = [f"{fid} {times}" for fid, times in sorted(self.kfs_used_times.items())]
        (base / f"keyframe_used_times_{self.iteration}.txt").write_text("\n".join(lines) + "\n")

    def load_ply(self, ply_path: str | Path) -> None:
        """loadPly (:984-1059): a view-only restore (no optimizer state,
        like the reference), on the mapper's device."""
        self.model = ply_dict_to_gaussians(read_ply(ply_path), device=self.device)
        self.adam = AdamState.init(self.model.params())
        self.initial_mapped = True
        self._invalidate_binning_caches()
