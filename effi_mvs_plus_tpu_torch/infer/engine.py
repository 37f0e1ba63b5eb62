"""Depth-map inference engine.

Port of ``effi_mvs_plus_tpu/infer/engine.py``: the forward per batch of
reference views, the final depth + confidence pulled to the host and
written as PFM + cam text + preview jpg per reference view.  Runs on
``cuda`` unless the caller passes another device; the forward runs under
``torch.inference_mode()``.  With ``shard_policy`` in a multi-process
run the ranks cooperate on every batch: each runs its block of the
source views or of the image rows (``parallel/mesh.py``), every rank
gets the whole maps, and rank 0 writes them.  The JAX engine's in-process batch split (``_fit_devices``)
becomes the CLIs' per-rank partition of scans and scenes.

Copies on a CUDA device.  A pageable ``cudaMemcpy`` moves the bytes
through the driver's own small pinned buffer on one host thread, about
5.6 GB/s on the H100's host: 42% of a B=6 DTU batch at 1600x1184.  So
the engine uploads through ``_PinnedRing``: a few pinned host slots that
torch's intra-op threads fill chunk by chunk while the previous chunk's
DMA runs on a copy stream, into device tensors of the plain copy's
dtype, shape and bytes.  The maps come back into pinned host tensors
(torch's caching host allocator), a fresh pair a call, so no later call
overwrites what an earlier one returned.  On the CPU the copies are the
plain ones.

Spans (``utils/profiling.py``): a batch is the unit ``engine.batch``
(with the device's time), holding ``engine.upload`` (the host-to-device
copies; counters ``engine.upload_bytes``, and on a CUDA device
``engine.upload_staged_bytes``, the bytes that went through the ring,
and ``engine.upload_chunks``, its slot fills), ``engine.forward`` (the
model's dispatch, with the device's time) and, in ``infer_batch``,
``engine.readback`` (the host waiting for the forward and the copy
back).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from effi_mvs_plus_tpu_torch.data import cams as camio
from effi_mvs_plus_tpu_torch.data.pfm import save_pfm
from effi_mvs_plus_tpu_torch.models import (EffiMVSConfig, build_model,
                                             freeze_kernel_weights)
from effi_mvs_plus_tpu_torch.parallel import distributed as D
from effi_mvs_plus_tpu_torch.parallel import mesh as par
from effi_mvs_plus_tpu_torch.utils import profiling
from effi_mvs_plus_tpu_torch.utils.profiling import span

_STAGES = ("stage1", "stage2", "stage3")

# The staging ring: SLOTS pinned host buffers of SLOT_BYTES each, sized on
# the H100 (PERF.md §6).  A fixed size, whatever the batch.
SLOT_BYTES = 32 << 20
SLOTS = 4


def chunk_plan(nbytes, slot_bytes=SLOT_BYTES):
    """The byte ranges [(start, stop)] in which an upload of ``nbytes``
    goes through the ring, one slot each, in order."""
    return [(a, min(a + slot_bytes, nbytes))
            for a in range(0, nbytes, slot_bytes)]


class _PinnedRing:
    """Host-to-device copies of numpy arrays through pinned slots.

    Each array's bytes go in ``chunk_plan`` order: torch's intra-op
    threads fill the next slot from the pageable array while the copy
    stream's DMA of the previous slot runs; a slot is refilled only after
    the event of the copy that last read it.  The copy stream first waits
    for the current stream (the destinations may reuse memory its queued
    work still reads), and the current stream waits for the copy stream
    before anything else runs on it, so the destinations, allocated on
    the current stream, need no ``record_stream``."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [torch.empty(SLOT_BYTES, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(SLOTS)]
        self.events = [torch.cuda.Event() for _ in range(SLOTS)]
        self.next = 0

    def upload(self, a):
        """A device tensor bitwise equal to ``torch.from_numpy(a).to(
        device)`` of the C-contiguous array ``a``."""
        host = torch.from_numpy(a)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        out = torch.empty_like(host, device=self.device)
        src = host.view(-1).view(torch.uint8)
        dst = out.view(-1).view(torch.uint8)
        try:
            with torch.cuda.stream(self.stream):
                self._copy(src, dst)
        finally:
            cur.wait_stream(self.stream)
        return out

    def _copy(self, src, dst):
        """Bytes ``src`` (host) into ``dst`` (device) slot by slot."""
        for start, stop in chunk_plan(src.numel()):
            k = self.next
            self.next = (k + 1) % SLOTS
            self.events[k].synchronize()        # its last DMA has read it
            slot = self.slots[k][:stop - start]
            slot.copy_(src[start:stop])
            dst[start:stop].copy_(slot, non_blocking=True)
            self.events[k].record(self.stream)
            profiling.count("engine.upload_chunks")
        profiling.count("engine.upload_staged_bytes", src.numel())


def _to_host(t):
    """A device tensor as numpy.  From a CUDA device through a pinned host
    tensor of its own (torch's caching host allocator), which the
    returned array keeps alive."""
    if t.device.type != "cuda":
        return t.cpu().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
    return host.numpy()


class InferenceEngine:
    def __init__(self, state_dict, cfg: EffiMVSConfig = EffiMVSConfig(),
                 buckets=None, device=None, shard_policy=None):
        """state_dict: the network's weights (``io.load_state_dict`` of a
        shipped ``.npz``, a torch ``.ckpt`` or a JAX train checkpoint),
        loaded strictly.  device: ``cuda`` unless the caller names
        another; with no GPU the default raises.

        buckets: optional list of (H, W) size buckets (ascending area).
        An input is zero-padded bottom/right to the smallest bucket that
        holds it and the outputs are cropped back: the pad rim lies beyond
        every real pixel, the principal point does not move, and zeros
        match the warp's out-of-image convention, so real-area depths are
        unaffected outside a receptive-field-wide edge band.

        shard_policy: in a multi-process run (``parallel.initialize``), put
        every rank on the model axis (data = 1) and split each batch over
        the ranks by these model-axis layouts, a comma list as the train
        CLI's ``--shard_policy`` (``parallel.make_policy``): ``views``
        (the source views), ``spatial`` (the image rows) or
        ``views,spatial``; every rank must then run the same batches.  A
        single process ignores it."""
        self.model = freeze_kernel_weights(build_model(state_dict, cfg,
                                                       device))
        self._policy = None
        if shard_policy and D.world_size() > 1:
            self._policy = par.make_policy(
                D.global_mesh(model=D.world_size()), shard_policy)
        self.device = next(self.model.parameters()).device
        self.cfg = cfg
        self.buckets = (sorted(buckets, key=lambda hw: hw[0] * hw[1])
                        if buckets else None)
        self._ring = None               # pinned staging, at the first upload

    def _run(self, imgs, proj_matrices, depth_values):
        with torch.inference_mode(), par.use_policy(self._policy), \
                span("engine.forward", self.device):
            out = self.model(imgs, proj_matrices, depth_values)
            return (out["depth"][-1].float(),
                    out["photometric_confidence"].float())

    def _pick_bucket(self, H, W):
        for bh, bw in self.buckets:
            if bh >= H and bw >= W:
                return bh, bw
        return None

    def _to_device(self, a):
        """A host array on the device: through the pinned ring on a CUDA
        device where the array is C-contiguous, else the plain copy."""
        a = np.asarray(a)
        profiling.count("engine.upload_bytes", a.nbytes)
        if self.device.type == "cuda" and a.flags.c_contiguous:
            if self._ring is None:
                self._ring = _PinnedRing(self.device)
            return self._ring.upload(a)
        return torch.as_tensor(a).to(self.device)

    def _infer_device(self, batch):
        """Launch the forward for one batch; returns DEVICE tensors
        (depth, conf) without waiting for the device, so the caller can
        overlap host work with the forward."""
        crop = None
        imgs = batch["imgs"]
        if self.buckets is not None:
            H, W = imgs.shape[2], imgs.shape[3]
            bucket = self._pick_bucket(H, W)
            if bucket is not None and bucket != (H, W):
                bh, bw = bucket
                imgs = np.pad(np.asarray(imgs), ((0, 0), (0, 0), (0, bh - H),
                                                 (0, bw - W), (0, 0)))
                crop = (H, W)
        with span("engine.upload"):
            projs = {k: self._to_device(batch["proj_matrices"][k])
                     for k in _STAGES}
            imgs = self._to_device(imgs)
            depth_values = self._to_device(batch["depth_values"])
        depth, conf = self._run(imgs, projs, depth_values)
        if crop is not None:
            H, W = crop
            depth = depth[:, :H, :W]
            conf = conf[:, :H // 2, :W // 2]
        return depth, conf

    def infer_batch(self, batch):
        """batch: dict with imgs (B,V,H,W,3), proj_matrices stage dicts,
        depth_values (B,Nd).  Returns (depth (B,H,W), conf (B,H/2,W/2))
        as numpy."""
        with span("engine.batch", self.device):
            depth, conf = self._infer_device(batch)
            with span("engine.readback"):
                return _to_host(depth), _to_host(conf)

    @staticmethod
    def _write_batch(outdir, batch, depth, conf):
        """Host side of one batch: wait for the device tensors and write
        depth_est/ confidence/ cams/ images/ in the reference layout."""
        depth = _to_host(depth)                    # waits for the forward
        conf = _to_host(conf)
        for b in range(depth.shape[0]):
            template = batch["filename"][b]
            depth_path = os.path.join(
                outdir, template.format("depth_est", ".pfm"))
            conf_path = os.path.join(
                outdir, template.format("confidence", ".pfm"))
            cam_path = os.path.join(
                outdir, template.format("cams", "_cam.txt"))
            img_path = os.path.join(
                outdir, template.format("images", ".jpg"))
            for p in (depth_path, conf_path, cam_path, img_path):
                os.makedirs(os.path.dirname(p), exist_ok=True)
            save_pfm(depth_path, depth[b])
            save_pfm(conf_path, conf[b])
            # full-resolution (stage4) cams for fusion
            proj = np.asarray(batch["proj_matrices"]["stage4"][b, 0])
            dv = np.asarray(batch["depth_values"][b])
            depth_min = 1.0 / float(dv.max())   # dv = ascending inverse depths
            depth_max = 1.0 / float(dv.min())
            camio.write_cam_file(
                cam_path, proj[0], proj[1][:3, :3],
                [depth_min, (depth_max - depth_min) / len(dv),
                 float(len(dv)), depth_max])
            # the T&T fusion second pass re-reads images/, so a failed
            # write must be loud; only a missing PIL is tolerated, with a
            # warning once
            img = (np.asarray(batch["imgs"][b, 0]) * 255).astype(np.uint8)
            try:
                from PIL import Image
            except ImportError:
                if not getattr(InferenceEngine, "_warned_no_pil", False):
                    InferenceEngine._warned_no_pil = True
                    print("WARNING: PIL unavailable — skipping images/ "
                          "writes (T&T fusion re-reads them)", flush=True)
            else:
                Image.fromarray(img).save(img_path)
        return depth.shape[0]

    def save_scene_depths(self, loader, outdir, verbose=True):
        """Run a whole eval loader, writing depth_est/ confidence/ cams/
        images/ in the reference output layout (view-sharded: rank 0
        writes).  Returns
        {'maps', 'total_s', 's_per_map', 'device_s'}: host wall time, and
        on a GPU the device time of the batches' uploads and forwards (the
        ``engine.batch`` spans', a tracing block each; None on the CPU).

        Pipelined: the forward for batch N+1 is launched while a writer
        thread waits for batch N's outputs and writes its files.  The
        queue bound caps the output tensors in flight."""
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=2)
        state = {"maps": 0, "err": None, "device_ms": 0.0}
        on_gpu = self.device.type == "cuda"
        writes = self._policy is None or D.is_main()

        def writer():
            while True:
                item = q.get()
                if item is None:
                    return
                try:
                    batch, depth, conf, rec = item
                    if writes:
                        wrote = self._write_batch(outdir, batch, depth, conf)
                    else:
                        wrote = depth.shape[0]
                    if on_gpu:
                        state["device_ms"] += rec.device_ms(
                            "engine.batch") or 0.0
                    state["maps"] += wrote
                    if verbose:
                        print(f"inferred {state['maps']} maps", flush=True)
                except Exception as e:          # surface on join
                    state["err"] = e
                    return

        def put(item):
            """Bounded put that can't deadlock if the writer died."""
            while state["err"] is None:
                try:
                    q.put(item, timeout=1.0)
                    return True
                except queue.Full:
                    continue
            return False

        t0 = time.perf_counter()
        th = threading.Thread(target=writer, daemon=True)
        th.start()
        dropped = 0
        for batch in loader:
            with profiling.tracing() as rec, \
                    span("engine.batch", self.device):
                depth, conf = self._infer_device(batch)
            dropped += rec.dropped
            if not put((batch, depth, conf, rec)):
                break
        put(None)
        th.join()
        if state["err"] is not None:
            raise state["err"]
        if on_gpu and dropped:
            raise RuntimeError(f"{dropped} spans past the tracer's CAPACITY "
                               "(an outer tracing block is full): the "
                               "device time would read low")
        total = time.perf_counter() - t0
        return {"maps": state["maps"], "total_s": total,
                "s_per_map": total / max(state["maps"], 1),
                "device_s": state["device_ms"] / 1e3 if on_gpu else None}
