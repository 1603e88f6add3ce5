#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its seconds:
  device     the card's name, count and power limit; no card is an error.
  build      nvcc builds the CUDA kernels (K1 flash attention, K2 fused
             GroupNorm -> SiLU -> conv3x3, K3 fused motion module, K4
             nearest-2x + conv3x3 + leaky ReLU), one compile a source, all
             in parallel, then one link (meanwhile torch.profiler makes
             its first, slow start on a thread: `profiler_start_seconds`);
             prints its time and nvcc's register / spill report. After the
             cfg phase (`cuobjdump -sass` runs on the thread meanwhile)
             K1's, K2's, K3's and K4's report each on a line of its own.
             K1's line adds the dynamic shared memory of each bf16
             plan and the tensor-core (HMMA) instructions that `cuobjdump
             -sass` finds in each K1 kernel: every bf16 K1 kernel (one a
             head dim, 64 among them) must have some and spill no
             registers. K2's line adds the HMMA and cp.async (LDGSTS)
             instructions of each K2 kernel: every bf16 K2 kernel must have
             both, and spill no registers. K3's line (`k3_ptxas`) adds the
             HMMA, LDGSTS and LDSM (ldmatrix) instructions of each K3
             kernel: every bf16 K3 GEMM kernel must have all three, and
             spill no registers. K4's line (`k4_ptxas`) likewise: every bf16
             K4 kernel must have HMMA, LDGSTS and LDSM and spill no
             registers.
  reference  a small pipeline (head dims 40/80/512, fp32) on the card against
             the same pipeline on the CPU with the same weights and noise:
             uint8 frames within 1 LSB; then the same with
             `use_pallas_conv` and 128-channel VAE levels, so that K2 runs
             on the card, and once more with CONTROLANIMATE_PALLAS_MOTION=1,
             so that K3 runs on the card (K2's and K3's launches are counted
             and must be nonzero); then a small fp32 RealESRGAN `Upscaler`
             (64 features, 1 block, 2 frames of 64x64) on the card against
             the same on the CPU, at scale 4 and at scale 2 (the x4 network
             then Lanczos4): uint8 within 1 LSB, K4's launches nonzero;
             then the face step (`small_face_reference`: a tiny GFPGAN and
             the real-architecture RetinaFace on a 96x80 frame, two faces
             given by landmarks) on the card against the CPU: the
             detector's outputs within 1e-3 of their largest value, the
             aligned crops equal, the restored crops and the frame pasted
             at 2x within 1 LSB; then canny on the card against canny on
             the CPU on 2 synthetic frames at 512x768 (the cfg and
             controlnet phases run it at 512x512 on the card), as
             they are and with a hard-edged checkerboard added (`edge_rich`):
             equal maps; the full HED network (seeded by `init_hed_`) on 2
             frames of 64x80, card against CPU in fp32: within 1 LSB after
             the uint8 quantisation; lineart, MLSD, softedge,
             lineart_anime and NormalBae likewise
             (`small_annotator_reference`: lineart and PidiNet at 64x80
             (48x96 in tests/test_torch_gpu.py), the full-width
             lineart_anime at 200x120 (its two cubic resizes, the network
             at 256x256), each within 1 LSB and not saturated;
             `small_normalbae_reference`, a step of its own: the full B5
             NormalBae at 64x80 and 45x61 (odd sides), within 1 LSB and not
             saturated; `small_depth_reference`, a step of its own: the
             full-width DPT (4 ViT layers) and DPT-hybrid (2), position
             tables for 128x128, on one frame in fp32 (K1's fp32 plan at
             head dim 64), and GLPN at the MiT-b0 widths on one
             GLPN_REF_HW frame (K1's fp32 plan at head dim 32 on every
             stage, its launches by shape checked), within 1e-4 of the
             largest value; MLSD's
             tpMaps within 1e-3 of each channel's RMS,
             and the map the card decodes and draws from its own tpMap equal
             to the CPU's decode and drawing of it; INTER_AREA at 768x512
             and 1024x1024 to 512x512 and 600 random segments drawn, equal);
             OpenPose (`small_openpose_reference`: the seeded body, hand and
             face networks, each output channel within 1e-3 of its RMS; the
             crafted maps of two people at 768x512 decoded and drawn, and
             the hand and face heat of their boxes decoded and drawn, on the
             card equal to the CPU, a hand and a face drawn at least;
             INTER_CUBIC and the Gaussian filter equal);
             and the small pipeline with two
             ControlNets of its UNet's down path (canny at 1.0, HED at 0.5)
             on the card against the CPU in fp32: uint8 within 1 LSB, and
             changed by the ControlNets; then one whole 64x64 window of
             DPM-Solver (3 steps, its second-order update at the middle
             one) under CFG 7.5 with a canny ControlNet (guess mode off) and
             CONTROLANIMATE_PALLAS_MOTION=1, card against CPU in fp32
             within 1 LSB: K1 must run at B*F = 8 and K3 at B = 2, and the
             window must differ from the same window on the card at
             guidance 1.0 (Euler under CFG and the LCM-LoRA tail run at
             full width in the cfg and disk phases; their 64x64
             card-against-CPU windows are in tests/test_torch_gpu.py); then
             the segment-parallel loop (`small_segment_reference`: the
             small fp32 pipeline, `parallel_segments` 2, 8 frames, one
             window a segment; two in tests/test_torch_gpu.py) on the card
             against the CPU, each window within 1 LSB (the written frames
             reported), and its first window against the
             sequential loop on each segment's frames alone on the card,
             within 1 LSB. The line holds each step's seconds
             (`step_seconds`).
  window     the native-LCM window at full SD1.5 width through the facade
             (512x512, 16 frames, 4 LCM steps, no CFG, strength 0.9), random
             bf16 weights made on the card from a seed. One warm-up window,
             WINDOWS windows without overlap (frames/s as bench.py counts it:
             16 frames a window), then WINDOWS windows of the overlap-8 stream
             (8 new frames a window, overlap latents reused). K1's launches
             are counted per shape over the phase and must equal what the
             UNet and VAE imply.
  window_plain_attention
             the first overlap-8 window again with the plain attention on
             the same inputs (time and uint8 difference reported, not
             gated).
  profile    the first overlap-8 window again, under torch.profiler (the
             card's activity only): the device's busy time (its kernels'
             and copies' time summed; one stream, so they do not overlap),
             its idle share of the window phase's mean overlap window, the
             ten kernels with the most device time, and K1's share of the
             busy time.
  window_motion_kernel
             the overlap-8 windows again on the same models and inputs, from
             a pipeline built with CONTROLANIMATE_PALLAS_MOTION=1, so that
             the UNet's 21 motion modules run on K3 (after one warm-up
             window): seconds, new frames/s, peak memory, and the uint8
             difference against the K3-off windows (reported, not gated).
             K3's launches by shape must equal what the UNet implies (84 a
             window).
  vid2vid    the main path: the port's `vid2vid` loop at full width, the
             same models, 512x512, 16-frame windows with overlap 8, 4 LCM
             steps, strength 0.9, bf16, `use_pallas_conv` on: seeded
             synthetic frames with motion for one whole window and
             V2V_OVERLAP_WINDOWS overlap windows, from an ArrayFrameSource to
             an ArrayFrameSink. Checks the frames written, their shape and
             dtype, that the stitch's color match changed window 2 onwards,
             and K1's and K2's launches by shape against what the UNet and
             the VAE imply. Prints new frames/s (frames written / loop
             seconds, the first window included), the loop's phase timers
             and peak memory.
  vid2vid_plain_conv
             the same loop with `use_pallas_conv` off (time and uint8
             difference reported, not gated); then one line with both
             phases' peak memory and their difference (reported).
  window_variants
             the UNet's attention variants: the window phase's UNet rebuilt
             with the inference yaml's `unet_use_cross_frame_attention` and
             `unet_use_temporal_attention` (every weight copied, the
             sub-layer's `attn_temp` and `norm_temp` seeded, so that it is
             no identity) and motion band VARIANT_BAND, driven through the
             same loop (K2 off) with `temporal_band` VARIANT_BAND and
             CONTROLANIMATE_PALLAS_MOTION=1 over the first 24 frames (one
             whole and one overlap window). Checks 24 frames written that
             are not constant and differ from vid2vid_plain_conv's, K1's
             launches by shape (`variant_k1_launches`: sparse-causal attn1
             at (16, N, 2N, 8, D), the sub-layer at (N, 16, 16, 8, D), the
             VAE's), and K3 never launched (the band is active at 16
             frames); then one window with the band at 15 (every frame
             pair: exact dense attention), where K3 must launch 84 times.
             Prints new frames/s, seconds a window beside
             vid2vid_plain_conv's, peak memory and the loop's timers.
  controlnet this slice's path: the same loop (K2 off) with two full-width
             SD1.5 ControlNets (`lllyasviel/sd-controlnet-canny` at 1.0,
             `lllyasviel/sd-controlnet-hed` at 0.5; seeded by
             `init_weights_`, so their zero-conv heads are not zero) and a
             full-width HED seeded by `init_hed_`: each window annotated on
             the UNet, over the first 24 frames (one whole and one overlap
             window). Checks 24 frames written, frames that differ from
             vid2vid_plain_conv's, and K1's launches by shape: the UNet's,
             the VAE's and each ControlNet's 7 self-attentions a step (244
             at 512x512). Prints new frames/s beside vid2vid_plain_conv's,
             peak memory, the loop's timers (`annotate` among them), and by
             CUDA events each annotator's time on a 16-frame window and
             each ControlNet's forwards of a window (the first net's also
             on the card alone). Before that, an `annotators_512x768` line: canny, HED,
             and the seeded lineart (`seed_lineart_`), MLSD
             (`mlsd_checkpoint`, its head set on a window of this phase),
             OpenPose (`openpose_checkpoints`), PidiNet
             (`pidinet_checkpoint`, its classifier set on that window),
             lineart_anime (`seed_lineart_anime_`), NormalBae
             (`normalbae_checkpoint`, its statistics from that window) and
             the full-depth DPT and DPT-hybrid depth networks
             (`dpt_checkpoint`, `dpt_hybrid_checkpoint`, their heads set
             on that window) and GLPN at the published MiT-b4 widths
             (`glpn_checkpoint`, its head set on that window at 512x512)
             that the disk phase writes (all but the
             DPTs), each timed by CUDA events on one 16-frame window
             at the shipped 512x768 (its second call), with its peak memory
             above what was allocated before it and the maps' mean and
             std, each channel's too (a constant map fails, but the seeded
             OpenPose's, which finds no one, and so does a depth map whose
             std is 0.05 or less, a map that differs on a second call, and
             K1's launches in the depth networks' second calls other than
             their 24 and 12 ViT layers at (16, 577, 577, 16 or 12, 64)
             and GLPN's 41 layers at (16, 24576, 384, 1, 64), (16, 6144,
             384, 2, 64), (16, 1536, 384, 5, 64) and (16, 384, 384, 8,
             64), 3, 8, 27 and 3 of them);
             then OpenPose's decode,
             hand and face crops and drawing timed again on crafted maps of
             two people in each frame (`pose_maps`), with the people, hands
             and faces drawn and the decode's host seconds.
  cfg        the multi-step path (SampleConfig.yaml's sampler): the same
             loop, K2 on, over one whole 16-frame window at strength 1.0
             with `EulerDiscreteScheduler`, 10 steps (the shipped 30 cut
             to a third), guidance 7.5 over the
             negative and positive prompts, and the controlnet phase's canny
             ControlNet at 1.0; the SD1.5 UNet without the LCM w-embedding
             (`time_cond_proj_dim` None, the window phase's weights). Checks
             16 frames written, K1's launches by shape (the UNet's 16 and
             the ControlNet's 7 self-attentions a step at B*F = 32, the
             VAE's mid attention in the decode) and K2's against the VAE's
             calls, and that guidance changes the window's first step:
             that step through the engine under CFG 7.5 and again at
             guidance 1.0 from the same latents must differ (that it
             changes a whole window's frames is checked at 64x64 in
             `reference`). Prints new frames/s, one UNet and one ControlNet
             forward on the doubled batch by CUDA events, peak memory and
             the loop's timers.
  vid2vid_upscale
             the upscale path: the same loop (K2 off) with `upscale` 4 and
             a full-width RealESRGAN x4 RRDBNet (64 features, 6 blocks,
             random weights seeded on the card, run in bf16), its tail on K4,
             over the first 24 frames (one whole and one overlap window).
             Checks 24 frames of (2048, 2048, 3) uint8 written and K4's
             launches by shape against what the upscaler's chunking implies
             (3 a chunk); prints new frames/s, peak memory, the loop's
             timers, the device time of one emit's upscale and of its RRDB
             body (CUDA events), the share of output values at 0 or 255,
             and the uint8
             difference against the same upscaler applied on the card to the
             vid2vid_plain_conv phase's frames of the two windows' emits
             (reported, not gated).
  disk       the disk build and the CLI, the path of the shipped profiles:
             writes a synthetic HF-layout snapshot of the window phase's
             bf16 models under build/chip_smoke_snapshot/ (unet/, vae/,
             text_encoder/ as config.json + safetensors written by
             `weights/ingest.py` `save_safetensors`, tokenizer/ with the
             tiny vocabulary, and AnimateDiff v2 and v1 motion checkpoints
             with their PE tables by torch.save), the upscaler and face models (below), and the
             frames of each run as PNG directories; runs
             `python -m controlanimate_tpu_torch --config` in-process on
             it, frames from the PNG directory and PNGs out (no ffmpeg).
             The weight files are written on threads (`write_parallel`).
             The controlnet phase's two ControlNets and three more seeded
             ones (openpose, lineart, MLSD) are written as diffusers folders
             (config.json + safetensors, bf16) under the snapshot's
             models/ControlNet/, and its HED, lineart, MLSD and OpenPose
             networks as models/annotators/ ControlNetHED.pth,
             sk_model.pth, mlsd_large_512_fp32.pth (in controlnet_aux's
             layout, BatchNorms unfolded), body_pose_model.pth,
             hand_pose_model.pth, facenet.pth, table5_pidinet.pth (the
             released nesting: `state_dict`, `module.` keys, unfolded PDC
             kernels), netG.pth and normalbae/scannet.pt (the released
             nesting: `model`, `module.` keys, BatchNorms unfolded), and
             GLPN as models/annotators/glpn/ (config.json and
             model.safetensors, transformers keys), and the next runs
             start from the
             snapshot root, which finds them there. First the
             controlnet phase's native-LCM profile at 512x512 on
             inference-v2.yaml with K2 off, one window (`--max-windows 1`,
             8 frames written): its frames must equal the controlnet
             phase's first 8 and its K1 launches by shape those that one
             window with both ControlNets implies. Then the same profile
             naming `lllyasviel/control_v11p_sd15_softedge`,
             `lllyasviel/control_v11p_sd15s2_lineart_anime`,
             `lllyasviel/control_v11p_sd15_normalbae` and
             `lllyasviel/control_v11f1p_sd15_depth` (their folders link
             to the canny, HED, MLSD and lineart nets': the name selects
             the annotator, PidiNet, lineart_anime, NormalBae and GLPN
             (b4) read from the files, GLPN from models/annotators/glpn/,
             which CONTROLANIMATE_DEPTH_MODEL names), one window: its
             frames must equal the injected pipeline's with the same nets
             and the controlnet phase's seeded annotators, and its K1
             launches by shape those that one window with four
             ControlNets implies plus GLPN's 41 layers at 512x512. Then
             the LCM-LoRA
             profile's files (SampleConfigLCMLoRA.yaml: openpose at 1.0,
             lineart at 0.35, MLSD at 1.0 and HED at 0.4; 512x768,
             `upscale` 2 and the face enhancer with `upscale_first` 1, on
             the files the 512x768 run below reads) with a synthetic
             Kohya-layout LoRA (`kohya_lora`) on the UNet's cross-attention
             and the text encoder's attention projections, fused on the
             host into the injected pipeline (the same nets and
             annotators, an Upscaler read from the same files) that the
             next run is held against. Then the
             IP-Adapter profile as shipped
             (SampleConfigIPAdapter.yaml, its settings checked against the
             file: the LCM-LoRA profile's LoRA, ControlNets, geometry,
             upscale and faces, the ControlNets in guess mode, 12 steps, CFG
             1.35, `use_ipadapter` at ipa_scale 0.65 and
             `do_initial_generation`) through the CLI from the snapshot
             root, the snapshot read as `pretrained_model_path` with the
             LoRA file, where a seeded full-width CLIP ViT-H/14 image encoder
             (config.json and HF-key safetensors, bf16, 632 M parameters)
             and a base-layout ip-adapter_sd15.bin (`image_proj` of 4
             tokens, `ip_adapter` K/V of the UNet's 16 cross-attentions) lie
             where the profile names them; one window (`--max-windows 1`),
             which is the initial double pass (the window from zero image
             tokens, again from its own last 8 frames at 0.92, the image
             encoder on the first of them): its K1 launches by shape (the
             UNet's at B*F = 32 over both passes' 23 steps, the four
             ControlNets' at B*F = 16, the VAE's, and the image encoder's
             32 at (1, 257, 257, 16, 80)) and its K4 launches must equal
             the counts from the code, K2 and K3 must not launch, every
             tensor of the pipeline the CLI built from disk (the UNet with
             the LoRA fused and the adapter's K/V, the VAE, the text encoder
             with the LoRA, the four ControlNets, the image encoder and the
             projection) must equal the injected one, and its frames must
             equal the injected pipeline's (the same tensors,
             its adapter read from the same files: the adapter's build
             seconds; then the image encoder's ms an embed by CUDA events;
             the people, hands and faces of the last OpenPose map, 0 with
             the seeded body network).
             In the CLI runs the weights, noise and kernels are those of
             the injected run (bf16); when the frames differ, the injected
             loop runs again and the difference may not exceed that
             rerun's.
             Then the whole shipped LCM profile (SampleConfigLCM.yaml): 512x768 on
             inference-v1.yaml (no mid-block motion module, non-inflated
             GroupNorm, PE 24 long) with K2 on, `upscale` 2 (the
             vid2vid_upscale phase's RealESRGAN, its tail on K4, then
             Lanczos4), the face enhancer with `upscale_first` 1 (a
             full-width GFPGANv1.3 and RetinaFace-ResNet50, seeded, written
             into the snapshot in their release layouts), over 16 frames
             (one window) to (1536, 1024) PNGs.
             Its K1, K2 and K4 launches by shape must equal what the UNet,
             the VAE and the upscaler's chunking imply, and its frames must
             equal those of the injected pipeline on inference-v1.yaml with
             the same weights through an Upscaler read from the same files
             (difference 0). The seeded detector finds no face at 0.97
             (`retinaface_checkpoint`), so nothing is restored there; the
             run reports the faces found and the detector's time a frame
             (CUDA events). Then the shipped SampleConfigMultiChip.yaml
             (its settings checked against the file) through the CLI
             without its `mesh_shape` (the port takes no mesh; JAX's
             make_mesh refuses [4, 2] on one device): 64 seeded 512x512
             PNGs in 4 segments of one 16-frame window each, run as one
             window at B*F = 64 (native LCM, 4 steps, inference-v1.yaml
             with mm_v1.ckpt, CONTROLANIMATE_PALLAS_MOTION=1, the VAE
             decoding 16 frames a pass): 64 frames of (512, 512, 3) not
             constant, K3's launches by shape at B = 4 (80: 20 v1 motion
             modules x 4 steps) and K1's as `expected_k1_launches` implies
             at batch 4, no K2, and its frames equal to the injected
             pipeline's S = 4 run of the same weights (difference 0); that
             run's loop seconds, new frames/s and peak memory beside the
             sequential loop's over each segment's 16 frames alone (the
             same injected pipeline), and the uint8 difference between
             them (reported, not gated: bf16 at two batch sizes). Prints
             the snapshot's write seconds and bytes, each run's disk-build
             seconds (the loop's `build_pipeline` timer), loop seconds and
             new frames/s (the PNG source and sink included), peak memory
             and timers; deletes the snapshot.
  face       the face step at full width on the card, on the disk phase's
             upscaled (1536, 1024) frames: the GFPGANv1.3 and RetinaFace of
             the snapshot, three faces a frame given by landmarks (widths
             0.45, 0.3 and 0.18 of the frame, rotated), one warm-up frame
             and FACE_FRAMES timed ones. Each stage timed by CUDA events:
             the detector, the alignment, GFPGAN and the paste; peak
             memory. Fails if GFPGAN's fp32 output is not finite, or a
             paste leaves its face's centre unchanged.
  kernels    K1 against its plain version at every shape the window phase,
             the window_variants and cfg phases and the disk phase's
             512x768, IP-Adapter and segment runs launched it with (the
             image encoder's (1, 257, 257, 16, 80) among them, its plain
             version timed; the plain version on slices of the batch where
             its scores would pass PLAIN_SCORE_BYTES), plus odd
             lengths (D = 32 among them) and K1_GRID_SHAPES (B*H past the
             grid's 65535 on y), in bf16, and in fp32 (the reference phase's dtype,
             which runs it at small shapes) at the odd lengths
             (`k1_mismatch` states the gates), with its achieved TFLOP/s
             and share of the bound in bf16; K2
             against its plain version at every shape the vid2vid phase and
             the 512x768 run launched it with, plus odd H, W and Cin, each
             with and without the affine + SiLU + residual, in bf16, and in
             fp32 (the reference phase's dtype, which runs it at 64x64) at
             the odd shapes (`k2_mismatch`), with K2's achieved TFLOP/s and share of
             the bound in bf16, and the GroupNorm fold's time and peak
             memory at the largest input it folds, beside the same
             statistics taken from full fp32 copies. Then each kernel's
             time, its plain version's (over PLAIN_ITERS calls, at the main
             path's 512x512 shapes), one
             PyTorch call's (SDPA for K1, `F.conv2d` on the activated input
             for K2: yardsticks the port never calls) and the bound, and
             their sums over a window at both geometries, and K1's over the
             vid2vid, controlnet, window_variants and cfg phases' and the
             IP-Adapter and segment runs' launches, and the image encoder's
             alone. Then
             K1 at the depth networks' shapes (16, 577, 577, 16 and 12, 64),
             GLPN's four b4 shapes at 512x768 and 512x512 (the disk
             phase's CLI run) and the reference's b0 GLPN shapes (D = 32)
             in fp32 (their dtype) against its plain version,
             and but at the 512x512 and b0 shapes the time, SDPA's and the
             bound (fp32 operations at the CUDA cores' 67 TFLOP/s), the
             plain version's time (a `k1_depth` line a shape), and
             their sums
             over the DPTs' and GLPN's timed launches (`depth_path`,
             `glpn_path`).
  kernels_k3 K3 against its plain version at every shape the
             window_motion_kernel phase and the disk phase's segment run
             (v1, B = 4; its plain version checked, not timed) launched it
             with, plus odd shapes
             (N = 37, F = 8 and 24, PE off, C = 64), in bf16 and fp32
             (`k3_mismatch` states the gates); then K3's time, its plain
             version's, the port's dense `TemporalTransformer3D`'s in bf16
             (the stock PyTorch path K3 replaces, as the yardstick) and the
             bound; and at each launched shape a `k3_stages` line: each of
             the chain's fourteen launches timed by CUDA events, each GEMM's
             TFLOP/s and each memory-bound pass's GB/s, the bytes the chain
             moves through device memory and their time at 3.35 TB/s beside
             the operation bound, and one PyTorch copy's GB/s; and there
             K3's and the dense path's time on the card alone
             (`device_ms`, `library_device_ms`: torch.profiler's summed
             activity, without the waits for the host that the CUDA-event
             times include); the line sums K3's times over the segment
             run's launches (`segments_path`).
  kernels_k4 K4 against its plain version at every shape vid2vid_upscale
             launched it with and at the disk phase's 512x768 run's (bf16
             as launched, there each frame of the batch against the plain
             version on that frame alone; the plain version not timed at
             the 512x768 shapes), plus odd shapes in both modes (H and W
             off the tiles, H = 1, Ci = Co = 32, B = 3, Ci = 128), in bf16,
             and at the odd shapes in fp32 at batch 1 (the reference
             phase's dtype; `k4_mismatch` states the gates), each called
             with the weights folded in the
             call and folded once (`packed`, as the upscaler calls it); then
             K4's time with the weights folded once (`ms`) and in the call
             (`unpacked_ms`), its TFLOP/s and GB/s, its plain version's
             time, one PyTorch call's (nearest-2x + `F.conv2d` + leaky ReLU
             in bf16, channels_last; a yardstick the port never calls), the
             bound over the useful work and the folded GEMM's work beside
             it; at each launched shape the launch plan (the block's shared
             memory, whether the weights stay resident, the grid and the
             tiles a block walks).
Then the kernels line, the `nvidia-smi` name/power-limit line, and last the
`{"ok": true, "device": ...}` line. Any failure ends the run non-zero.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import chdir, contextmanager, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# the spatial self-attention of one SD1.5 UNet forward (K1), by level: (token
# count divisor against the latent, head dim, transformer blocks): 5 at each
# of the full, 1/2 and 1/4 levels, 1 in the 1/8 mid block; 8 heads
UNET_LEVELS = ((1, 40, 5), (4, 80, 5), (16, 160, 5), (64, 160, 1))
# the same for one SD1.5 ControlNet (its down path and mid block): 2 at each
# of the full, 1/2 and 1/4 levels, 1 in the mid block
CONTROLNET_LEVELS = ((1, 40, 2), (4, 80, 2), (16, 160, 2), (64, 160, 1))
# the controlnet phase's nets (their names pick canny and HED) and scales
CN_NAMES = ("lllyasviel/sd-controlnet-canny", "lllyasviel/sd-controlnet-hed")
CN_SCALES = (1.0, 0.5)
# the ControlNet v1.1 softedge, anime-lineart, normalbae and depth nets'
# names and scales (the disk phase's CLI run gives them the canny, HED, MLSD
# and lineart nets' weights)
M13C_CN_NAMES = ("lllyasviel/control_v11p_sd15_softedge",
                 "lllyasviel/control_v11p_sd15s2_lineart_anime",
                 "lllyasviel/control_v11p_sd15_normalbae",
                 "lllyasviel/control_v11f1p_sd15_depth")
M13C_CN_SCALES = (1.0, 0.5, 0.8, 0.7)
# the disk phase's GLPN folder under the snapshot (CONTROLANIMATE_DEPTH_MODEL
# names it for the run that reads it)
GLPN_FOLDER = "models/annotators/glpn"
# the reference phase's GLPN at the MiT-b0 widths (head dim 32 on every
# stage): one frame of this size
GLPN_REF_HW = (128, 192)


def glpn_k1_launches(cfg, frames_n: int, hw: tuple[int, int]) -> dict:
    """K1's launches of one GLPN call on `frames_n` frames of `hw` (a
    multiple of 32), by (B, Nq, Nk, H, D): each stage's layers at its patch
    grid, its keys on that grid cut by sr a side."""
    h, w = hw
    out = {}
    for c, heads, sr, p, s, depth in zip(cfg.hidden_sizes, cfg.heads, cfg.sr_ratios,
                                         cfg.patch_sizes, cfg.strides, cfg.depths):
        h, w = ((n + 2 * (p // 2) - p) // s + 1 for n in (h, w))
        out[(frames_n, h * w, (h // sr) * (w // sr), heads, c // heads)] = depth
    return out
# the disk phase's LCM-LoRA run: SampleConfigLCMLoRA.yaml's ControlNets and
# scales
LORA_CN_NAMES = ("lllyasviel/control_v11p_sd15_openpose", "lllyasviel/control_v11p_sd15_lineart",
                 "lllyasviel/control_v11p_sd15_mlsd", "lllyasviel/sd-controlnet-hed")
LORA_CN_SCALES = (1.0, 0.35, 1.0, 0.4)


def unet_k1_shapes(frames_n: int, latent: tuple[int, int]) -> dict:
    """K1 launches of one UNet forward on `latent` (h, w), by (B*F, Nq, Nk,
    H, D)."""
    n = latent[0] * latent[1]
    return {(frames_n, n // div, n // div, 8, D): blocks for div, D, blocks in UNET_LEVELS}


ODD_SHAPES = [(2, 77, 77, 8, 40), (3, 333, 333, 2, 80), (1, 129, 129, 8, 160),
              (2, 77, 77, 1, 512), (1, 77, 300, 2, 64), (3, 129, 129, 1, 64),
              (3, 97, 50, 2, 32)]
# K1 where B*H passes 65535, the grid's y (it goes on in z): the temporal
# sub-layer's (B*N, F, F, H, D) at the full level of a 512x512, 16-frame
# window under CFG (B = 2) and on the segment path (B = 4)
K1_GRID_SHAPES = [(8192, 16, 16, 8, 40), (16384, 16, 16, 8, 40)]
# the window_variants phase's motion band (RunConfig.temporal_band): active
# at 16 frames; a band of F - 1 is exact dense attention and leaves K3 on
VARIANT_BAND = 4
# odd K2 shapes (B, H, W, Cin, Cout): H and W not multiples of the 16 x 16
# tile, H = 7, H = 1 with W = 16, and Cin = 80, whose last 32-channel chunk
# is a short one of 16
K2_ODD_SHAPES = [(2, 9, 37, 128, 128), (1, 7, 21, 256, 128), (2, 1, 16, 128, 256),
                 (2, 23, 45, 80, 256)]
# K3 launches of one SD1.5 UNet forward on a 512x512, 16-frame window, by
# (B, F, N, C, heads): the motion modules of the 64x64, 32x32, 16x16 and 8x8
# levels (the window_motion_kernel phase holds them against the module tree)
K3_SHAPES = {(1, 16, 4096, 320, 8): 5, (1, 16, 1024, 640, 8): 5, (1, 16, 256, 1280, 8): 5,
             (1, 16, 64, 1280, 8): 6}
# odd K3 shapes (B, F, N, C, heads, positional encoding): N not a multiple of
# the 128-row tile, 8 and 24 frames, PE off, and C = 64 (head dim 8)
K3_ODD_SHAPES = [(1, 16, 37, 320, 8, True), (1, 8, 64, 640, 8, True), (1, 24, 64, 320, 8, True),
                 (1, 16, 64, 1280, 8, False), (2, 16, 50, 64, 8, True)]
# odd K4 shapes (B, H, W, Ci, Co), each in both modes: H and W not multiples
# of the tiles (8 x 16 coarse upsample, 16 x 16 conv), H = 1, Ci = Co = 32
# (the 32-channel block), B = 3, and Ci = 128 (in the upsample mode the
# weights do not fit shared memory and are staged with each patch)
K4_ODD_SHAPES = [(2, 9, 37, 64, 64), (1, 1, 16, 64, 64), (1, 13, 21, 32, 32), (3, 8, 16, 64, 64),
                 (1, 11, 19, 128, 64)]
# conv_last's weight scale in the seeded RRDBNet (its bias is 0.5): keeps most
# uint8 outputs of the 6-block network off 0 and 255
RRDB_LAST_GAIN = 0.3
WINDOWS = 3  # timed windows of each kind
# calls K1's and K2's plain versions (10-20x their kernels' time) are timed
# over, with no warm-up: the check just before ran them at the same shape
PLAIN_ITERS = 1
V2V_OVERLAP_WINDOWS = 3  # overlap windows after the vid2vid phase's first window
FACE_FRAMES = 3  # the face phase's timed frames (after one warm-up frame)
# what the kernels phases sum at the 512x768 and CFG shapes, whose plain
# versions are checked but not timed
UNTIMED_PLAIN = ("ms", "library_ms", "bound_ms")
SEED = 7
# the disk phase's synthetic model zoo (build/ is git-ignored), the SD1.5
# LCM unet's and the SD VAE's config.json, and the AnimateDiff architectures
SNAPSHOT = ROOT / "build" / "chip_smoke_snapshot"
SD15_LCM_UNET_JSON = {"in_channels": 4, "out_channels": 4,
                      "block_out_channels": [320, 640, 1280, 1280], "layers_per_block": 2,
                      "attention_head_dim": 8, "cross_attention_dim": 768, "norm_num_groups": 32,
                      "time_cond_proj_dim": 256}
SD_VAE_JSON = {"block_out_channels": [128, 256, 512, 512], "norm_num_groups": 32,
               "scaling_factor": 0.18215}
INFERENCE_V1 = ROOT / "configs" / "inference" / "inference-v1.yaml"
INFERENCE_V2 = ROOT / "configs" / "inference" / "inference-v2.yaml"


def phase(name: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **fields}),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sass_counts(library: Path, cuobjdump: Path, opcodes: tuple[str, ...]) -> dict:
    """Instructions of each of `opcodes` in each kernel of the built library,
    from one `cuobjdump -sass`: {opcode: {kernel: count}}."""
    out = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    counts, current = {op: {} for op in opcodes}, None
    pattern = r"Function : (\S+)|\b(" + "|".join(map(re.escape, opcodes)) + r")\b"
    for m in re.finditer(pattern, out):
        if m.group(1):
            current = m.group(1)
            for op in opcodes:
                counts[op][current] = 0
        elif current is not None:
            counts[m.group(2)][current] += 1
    return counts


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills and shared memory per compiled kernel from -Xptxas -v."""
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"function": m.group(1)}
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(m2.group(1)) if m2 else 0
    return rows


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call, by CUDA events over `iters` calls after
    `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) times of softmax(QK^T)V on the card, in ms: FLOPs
    at the bf16 tensor rate (fp32, itemsize 4: the CUDA cores' rate), and
    each input read and the output written once at the memory rate. The
    bound is the larger."""
    B, Nq, Nk, H, D = shape
    flops = 4.0 * B * H * Nq * Nk * D
    nbytes = 2.0 * B * (Nq + Nk) * H * D * itemsize
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    return 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES


def k1_mismatch(torch, out, ref) -> str | None:
    """K1's gates on `out` against the plain version's `ref` (same dtype);
    None when it passes. fp32: atol = rtol = 1e-4 (TF32 off in the plain
    version). bf16: the JAX bf16 gate (atol = rtol = 3e-2), and also
    |out - ref| <= 1e-2 * (|ref| + rms(ref)), because outputs at the main
    path's lengths are about 0.03, so the first gate alone passes nearly
    anything. Both sides round P to bf16 against the row's exact max and the
    output once, so a right kernel differs from the plain version by the
    summation order, an exp that rounds otherwise, and then one bf16 ulp
    (< 2**-7 |ref|)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        return "non-finite output"
    tol = 3e-2 if bf16 else 1e-4
    if not torch.allclose(out, ref, atol=tol, rtol=tol):
        return f"max abs err {(out - ref).abs().max().item()} over atol = rtol = {tol}"
    if bf16:
        rms = ref.square().mean().sqrt()
        excess = ((out - ref).abs() - 1e-2 * (ref.abs() + rms)).max().item()
        if excess > 0:
            return f"bf16 error exceeds 1e-2 * (|ref| + rms(ref) = {rms.item()}) by {excess}"
    return None


# the plain version's fp32 scores a call, at most (its rounded copies take
# 1.5x that again): sparse-causal attention's (16, 4096, 8192, 8, 40) holds
# 17.2 GB of scores, so it is checked in slices of 4
PLAIN_SCORE_BYTES = 5e9


def check_kernel(torch, fa, shape, dtype, gen) -> float:
    """K1 at (B, Nq, Nk, H, D) against its plain version; max abs error. The
    plain version (whose fp32 scores and their rounded copy take 8 B H Nq Nk
    bytes) runs on slices of the batch when the whole would not fit."""
    B, Nq, Nk, H, D = shape
    q = torch.randn((B, Nq, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Nk, H, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out = fa.flash_attention(q, k, v)
    step = max(1, int(PLAIN_SCORE_BYTES // (4 * H * Nq * Nk)))
    ref = torch.cat([fa.flash_attention_plain(q[i:i + step], k[i:i + step], v[i:i + step])
                     for i in range(0, B, step)])
    bad = k1_mismatch(torch, out, ref)
    if bad:
        raise AssertionError(f"K1 {shape} {dtype}: {bad}")
    return (out.float() - ref.float()).abs().max().item()


def conv_bound_ms(shape, itemsize: int, residual: bool) -> tuple[float, float]:
    """(operations, bytes) times of one K2 call in ms: 2*9*B*H*W*Cin*Cout
    FLOPs at the bf16 tensor rate; x, the weights and the residual read once
    and the output written once at the memory rate."""
    B, H, W, Cin, Cout = shape
    flops = 2.0 * 9 * B * H * W * Cin * Cout
    nbytes = (B * H * W * (Cin + Cout + (Cout if residual else 0)) + 9 * Cin * Cout) * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES


def k2_mismatch(torch, out, ref) -> str | None:
    """K2's gates on `out` against the plain version's `ref` (same dtype);
    None when it passes. fp32: atol = rtol = 1e-4 (TF32 off in the plain
    version). bf16: |out - ref| <= 1e-2 * (|ref| + rms(ref)). Both sides
    convolve the same bf16-rounded operands in fp32 and round once, so a
    right kernel differs by the summation order and then at most one bf16
    ulp (< 2**-7 |ref|)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        return f"shape {tuple(out.shape)} against {tuple(ref.shape)}"
    if not bool(torch.isfinite(out).all()):
        return "non-finite output"
    if not bf16:
        if not torch.allclose(out, ref, atol=1e-4, rtol=1e-4):
            return f"max abs err {(out - ref).abs().max().item()} over atol = rtol = 1e-4"
        return None
    rms = ref.square().mean().sqrt()
    excess = ((out - ref).abs() - 1e-2 * (ref.abs() + rms)).max().item()
    if excess > 0:
        return f"bf16 error exceeds 1e-2 * (|ref| + rms(ref) = {rms.item()}) by {excess}"
    return None


def k2_inputs(torch, shape, dtype, gen):
    """Seeded K2 operands at (B, H, W, Cin, Cout): x, HWIO weights, bias,
    the folded affine (a, b) and a residual."""
    B, H, W, Cin, Cout = shape
    x = torch.randn((B, H, W, Cin), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((3, 3, Cin, Cout), generator=gen, device="cuda")
         / math.sqrt(9 * Cin)).to(dtype)
    bias = 0.1 * torch.randn((Cout,), generator=gen, device="cuda")
    a = (1.0 + 0.1 * torch.randn((B, Cin), generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn((B, Cin), generator=gen, device="cuda")).to(dtype)
    res = torch.randn((B, H, W, Cout), generator=gen, device="cuda").to(dtype)
    return x, w, bias, (a, b), res


K2_CHECKED = ({}, {"affine": True, "act": "silu", "residual": True})


def check_k2(torch, ck, shape, dtype, gen, variants=K2_CHECKED) -> float:
    """K2 at (B, H, W, Cin, Cout) against its plain version, for each of
    `variants` (the operands a call gets: by default none, then the affine
    + SiLU + residual); max abs error."""
    x, w, bias, affine, res = k2_inputs(torch, shape, dtype, gen)
    err = 0.0
    for variant in variants:
        kw = {"affine": affine} if variant.get("affine") else {}
        if variant.get("act"):
            kw["act"] = variant["act"]
        if variant.get("residual"):
            kw["residual"] = res
        out = ck.conv3x3_fused(x, w, bias, **kw)
        ref = ck.conv3x3_fused_plain(x, w, bias, **kw)
        bad = k2_mismatch(torch, out, ref)
        if bad:
            raise AssertionError(f"K2 {shape} {dtype} {sorted(kw)}: {bad}")
        err = max(err, (out.float() - ref.float()).abs().max().item())
    return err


def fold_cost(torch, fn, x) -> dict:
    """Time of one GroupNorm fold of x and the memory it takes above x at
    its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    return {"ms": cuda_ms(torch, lambda: fn(x), 5), "extra_peak_bytes": extra}


def fold_with_fp32_copies(x, groups: int = 32):
    """E[x] and E[x^2] of each group as the fold took them before it read x
    in place: from a full fp32 copy of x and a full squared copy (the
    yardstick of the k2_fold line)."""
    grouped = x.reshape(x.shape[0], -1, groups, x.shape[-1] // groups).float()
    return grouped.mean(dim=(1, 3)), grouped.square().mean(dim=(1, 3))


def motion_bound_ms(shape, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) times of one K3 call in ms, T = B*F*N tokens:
    T*(44 C^2 + 8 F C) FLOPs (the seven GEMMs and the frame attention) at the
    bf16 tensor rate; x read and the delta written once, and the 22 C^2
    weights read once, at the memory rate."""
    B, F, N, C = shape[:4]
    T = B * F * N
    flops = T * (44.0 * C * C + 8.0 * F * C)
    nbytes = (2.0 * T * C + 22.0 * C * C) * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES


def k3_mismatch(torch, out, ref) -> str | None:
    """K3's gates on `out` against the plain version's `ref` (same dtype);
    None when it passes. fp32: atol = rtol = 1e-4 (TF32 off in the plain
    version). bf16: |out - ref| <= 5e-2 * (|ref| + rms(ref)). Both sides round
    the same fp32 values to bf16 at the same dozen places but sum in other
    orders, so intermediates (h, q, k, a LayerNorm term, a probability) round
    one bf16 ulp the other way here and there, and the seven GEMMs carry that
    on. The bound is set by the function, not by the kernel: the plain
    version against itself with fp64 sums reaches 1.9-2.5e-2 (|ref| +
    rms(ref)) at the main-path widths (tests/test_torch_motion_kernel.py
    `test_bf16_gate_admits_another_summation_order`); 5e-2 is twice that. A
    wrong index, head, bias, PE row or residual moves outputs by O(rms)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        return f"shape {tuple(out.shape)} against {tuple(ref.shape)}"
    if not bool(torch.isfinite(out).all()):
        return "non-finite output"
    if not bf16:
        if not torch.allclose(out, ref, atol=1e-4, rtol=1e-4):
            return f"max abs err {(out - ref).abs().max().item()} over atol = rtol = 1e-4"
        return None
    rms = ref.square().mean().sqrt()
    excess = ((out - ref).abs() - 5e-2 * (ref.abs() + rms)).max().item()
    if excess > 0:
        return f"bf16 error exceeds 5e-2 * (|ref| + rms(ref) = {rms.item()}) by {excess}"
    return None


K3_GEMMS = {"proj_in": (1, 1), "qkv": (3, 1), "out": (1, 1), "w1_geglu": (8, 1), "w2": (1, 4),
            "proj_out": (1, 1)}  # (output columns, reduction depth) in units of C


def k3_stage_work(shape, stage: str, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch of K3's chain, by its name in
    `mk.STAGES`, T = B*F*N tokens: a GEMM's 2 T K Nw FLOPs (W1's useful 8C
    columns), and the bytes it moves through device memory (its A read, its
    outputs written, the residual read, its weights read once); a
    normalize pass reads h and writes z; the frame attention reads q|k (dtype)
    and v (fp32) and writes its output (dtype), 4 T F C FLOPs."""
    B, F, N, C = shape[:4]
    T, s = B * F * N, itemsize
    base = stage.rstrip("01")
    if base.startswith("norm"):
        return 0.0, 2.0 * T * C * s
    if base == "attn":
        return 4.0 * T * F * C, T * (3.0 * C * s + 4.0 * C)
    nw, k = K3_GEMMS[base]
    out = {"qkv": T * (2.0 * C * s + 4.0 * C), "w1_geglu": 4.0 * T * C * s}.get(base, T * C * s)
    res = T * C * s if base in ("out", "w2") else 0.0
    return 2.0 * T * nw * k * C * C, T * k * C * s + out + res + nw * k * C * C * s


def k3_stage_split(torch, mk, shape, x, p, pe, packed, reps: int = 5) -> dict:
    """Each launch of K3's chain at (B, F, N, C, heads, use_pe) in bf16 (CUDA
    events, the mean of `reps` chains after one warm-up), each GEMM's TFLOP/s
    and each memory-bound pass's GB/s; and the chain's bytes through device
    memory (the sum of `k3_stage_work`'s bytes: h, z, q|k, v, attn and the
    GEGLU output written and read back between launches) at 3.35 TB/s, beside
    its operation bound; and the GB/s of one PyTorch copy of an (M, C) bf16
    tensor, the yardstick of the memory-bound passes."""
    heads = shape[4]
    with torch.no_grad():
        mk.motion_module_stage_ms(x, p, heads=heads, pe=pe, packed=packed, reps=1)
        ms = mk.motion_module_stage_ms(x, p, heads=heads, pe=pe, packed=packed, reps=reps)
        flat = x.reshape(-1, x.shape[-1])
        copy_ms = cuda_ms(torch, flat.clone, reps)
    rates, chain_bytes = {}, 0.0
    for stage, t in ms.items():
        flops, nbytes = k3_stage_work(shape, stage, 2)
        chain_bytes += nbytes
        if stage.rstrip("01") in K3_GEMMS:
            rates[stage] = {"tflops": flops / t / 1e9}
        else:
            rates[stage] = {"gbps": nbytes / t / 1e6}
    return {"shape": list(shape), "ms": ms, "total_ms": sum(ms.values()), "rates": rates,
            "chain_bytes": chain_bytes, "chain_bytes_ms": 1e3 * chain_bytes / PEAK_BYTES,
            "ops_ms": motion_bound_ms(shape, 2)[0],
            "copy_gbps": 2 * flat.numel() * flat.element_size() / copy_ms / 1e6}


def pipelined_build_report(label: str, family: str, gated: str, ptxas: list[dict],
                           sass: dict) -> None:
    """Print the `{label}_ptxas` line (registers, spills and shared memory of
    each kernel whose name holds `family`, and its HMMA, LDGSTS (cp.async)
    and LDSM (ldmatrix) instructions); fail if a kernel whose name holds
    `gated` lacks any of the three or spills registers."""
    ops = {op: {name: n for name, n in sass[op].items() if family in name}
           for op in ("HMMA", "LDGSTS", "LDSM")}
    rows = [r for r in ptxas if family in r["function"]]
    print(json.dumps({f"{label}_ptxas": rows, f"{label}_hmma": ops["HMMA"],
                      f"{label}_ldgsts": ops["LDGSTS"], f"{label}_ldsm": ops["LDSM"]}), flush=True)
    kernels = [name for name in ops["HMMA"] if gated in name]
    if not kernels or not all(ops[op][n] for n in kernels for op in ops):
        raise AssertionError(f"{label.upper()} kernels {gated} without tensor-core (HMMA), "
                             f"cp.async (LDGSTS) or ldmatrix (LDSM) instructions: {ops}")
    spilled = [r for r in rows if gated in r["function"]
               and (r.get("spill_stores") or r.get("spill_loads"))]
    if spilled:
        raise AssertionError(f"{label.upper()} kernels {gated} spill registers: {spilled}")


def k3_module(torch, C: int, heads: int, use_pe: bool, gen):
    """A port `TemporalTransformer3D` of width C on the card in fp32, with
    seeded weights rounded to bf16 values (so that its bf16 copy holds the
    same weights): lecun-normal matrices (proj_out too, so the delta is not
    0), biases and norm shifts N(0, 0.1^2), norm scales 1 + N(0, 0.1^2); 32
    GroupNorm groups, or as many as divide C."""
    from controlanimate_tpu_torch.models.motion_module import TemporalTransformer3D

    mod = TemporalTransformer3D(C, heads, 1, ("Temporal_Self", "Temporal_Self"), 32, use_pe,
                                math.gcd(C, 32)).to("cuda")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
            else:
                p.normal_(1.0, 0.1, generator=gen)
            p.copy_(p.to(torch.bfloat16))
    return mod.eval()


def k3_inputs(torch, shape, gen):
    """(fp32 module, fp32 x) for K3 at (B, F, N, C, heads, use_pe), x ~ N(0, 1)
    rounded to bf16 values like the weights."""
    B, F, N, C, heads, use_pe = shape
    mod = k3_module(torch, C, heads, use_pe, gen)
    x = torch.randn((B, F, N, C), generator=gen, device="cuda").to(torch.bfloat16).float()
    return mod, x


def check_k3(torch, mk, shape, gen, fp32: bool = True) -> dict:
    """K3 at (B, F, N, C, heads, use_pe) against its plain version, in fp32
    and in bf16 on the same weights and input; the max abs errors, and the
    bf16 kernel's and the bf16 plain version's max abs error against the fp32
    plain version (how far each is from the function in fp32). Without
    `fp32` the fp32 kernel does not run (its error is None)."""
    import copy

    mod32, x32 = k3_inputs(torch, shape, gen)
    heads = shape[4]
    outs = {}
    with torch.no_grad():
        for mod, x in ((mod32, x32), (copy.deepcopy(mod32).to(torch.bfloat16), x32.bfloat16())):
            p, pe = mod.fused_operands(x)
            ref = mk.motion_module_plain(x, p, heads=heads, pe=pe)
            if x.dtype == torch.float32 and not fp32:
                outs[x.dtype] = (None, ref.float())
                continue
            out = mk.motion_module_fused(x, p, heads=heads, pe=pe)
            bad = k3_mismatch(torch, out, ref)
            if bad:
                raise AssertionError(f"K3 {shape} {x.dtype}: {bad}")
            outs[x.dtype] = (out.float(), ref.float())
    (out32, ref32), (out16, ref16) = outs[torch.float32], outs[torch.bfloat16]
    return {"max_abs_err_bf16": (out16 - ref16).abs().max().item(),
            "max_abs_err_fp32": None if out32 is None else (out32 - ref32).abs().max().item(),
            "bf16_kernel_vs_fp32": (out16 - ref32).abs().max().item(),
            "bf16_plain_vs_fp32": (ref16 - ref32).abs().max().item()}


def upconv_bound_ms(shape, upsample: bool, itemsize: int) -> tuple[float, float, float]:
    """(operations, bytes) times of one K4 call in ms, and the folded GEMM's
    GFLOP: the useful work, 2*4*Ci*Co FLOPs a fine output pixel (upsample)
    or 2*9*Ci*Co an output pixel (conv), at the bf16 tensor rate; x and the
    HWIO weights read once and the output written once at the memory rate.
    The TPU kernel's dense fold multiplies 2*9*Ci*4*Co a coarse pixel."""
    B, H, W, Ci, Co = shape
    px = B * H * W
    out_px = 4 * px if upsample else px
    flops = 2.0 * (4 if upsample else 9) * Ci * Co * out_px
    folded = 2.0 * 9 * Ci * (4 if upsample else 1) * Co * px
    nbytes = (B * H * W * Ci + out_px * Co + 9 * Ci * Co) * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES, folded / 1e9


def k4_mismatch(torch, out, ref) -> str | None:
    """K4's gates, K2's (`k2_mismatch`): fp32 at atol = rtol = 1e-4 (TF32 off
    in the plain version); bf16 within 1e-2 (|ref| + rms(ref)). Both sides
    fold the weights in fp32 and round them once, sum the same bf16 products
    in fp32 and round the result once, so a right kernel differs by the
    summation order and then at most one bf16 ulp (< 2**-7 |ref|)."""
    return k2_mismatch(torch, out, ref)


def k4_inputs(torch, shape, dtype, gen):
    """Seeded K4 operands at (B, H, W, Ci, Co): x in `dtype`, fp32 HWIO
    weights (the wrapper rounds them, folded or not) and bias."""
    B, H, W, Ci, Co = shape
    x = torch.randn((B, H, W, Ci), generator=gen, device="cuda").to(dtype)
    w = torch.randn((3, 3, Ci, Co), generator=gen, device="cuda") / math.sqrt(9 * Ci)
    bias = 0.1 * torch.randn((Co,), generator=gen, device="cuda")
    return x, w, bias


def check_k4(torch, uk, shape, upsample: bool, dtype, gen, by_frame: bool = False) -> float:
    """K4 at (B, H, W, Ci, Co) in one mode, with leaky ReLU, against its
    plain version, called with the weights folded in the call and with them
    folded once (`packed`, as the upscaler and the timed call pass them):
    equal bit for bit, and within the gates; max abs error. With `by_frame`
    the plain version runs on one frame at a time and each frame of the
    batched call is held to the gates on its own."""
    x, w, bias = k4_inputs(torch, shape, dtype, gen)
    out = uk.upconv3x3(x, w, bias, upsample=upsample, act="lrelu")
    packed = uk.kernel_weights(w, dtype, upsample)
    got = uk.upconv3x3(x, w, bias, upsample=upsample, act="lrelu", packed=packed)
    if not torch.equal(got, out):
        raise AssertionError(f"K4 {shape} upsample={upsample} {dtype}: packed weights "
                             f"give another output than weights folded in the call")
    del got
    err = 0.0
    for i in range(shape[0]) if by_frame else [None]:
        part = slice(None) if i is None else slice(i, i + 1)
        ref = uk.upconv3x3_plain(x[part], w, bias, upsample=upsample, act="lrelu")
        bad = k4_mismatch(torch, out[part], ref)
        if bad:
            raise AssertionError(f"K4 {shape} upsample={upsample} {dtype}, frame {i}: {bad}")
        err = max(err, (out[part].float() - ref.float()).abs().max().item())
        del ref
    return err


def init_rrdbnet_(torch, net, gen, last_gain: float) -> None:
    """Seeded weights for an RRDBNet on its device: `init_weights_`, then
    conv_last's weight times `last_gain` and its bias 0.5, so the [0, 1]
    output sits mostly inside the uint8 range."""
    init_weights_(torch, net, gen)
    with torch.no_grad():
        net.conv_last.weight.mul_(last_gain)
        net.conv_last.bias.fill_(0.5)


def small_upscaler_reference(torch, scale: float) -> dict:
    """A small fp32 Upscaler (64 features, 1 block; 2 frames of 64x64) on
    the CPU and on the card with the same weights: uint8 frames must agree
    within 1 LSB. Its x4 tail runs on K4 on the card; at a scale other than
    4 the Lanczos4 resize follows."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch.models.upscaler import RRDBNet, Upscaler

    net = RRDBNet(num_feat=64, num_block=1)
    init_rrdbnet_(torch, net, torch.Generator().manual_seed(SEED), 1.0)
    frames = synthetic_video(np, 2, 64, 64, SEED)
    out_cpu = Upscaler(scale, model=net, dtype=torch.float32, device="cpu").upscale_batch(frames)
    gpu = Upscaler(scale, model=copy.deepcopy(net), dtype=torch.float32, device="cuda")
    out_gpu = gpu.upscale_batch(frames)
    if out_gpu.shape != out_cpu.shape or out_gpu.shape[1] != int(64 * scale):
        raise AssertionError(f"upscaler output {out_gpu.shape} against {out_cpu.shape}")
    diff = np.abs(out_cpu.astype(np.int16) - out_gpu.astype(np.int16))
    return {"max_lsb": int(diff.max()), "mean_lsb": float(diff.mean())}


def expected_k4_launches(upscaler, emits: list[int], hw: tuple[int, int]) -> dict:
    """K4 launches by (B, H, W, Ci, Co, upsample) for emits of `emits`
    frames of hw = (height, width): each chunk of the upscaler's runs up1
    and up2 (upsample) and conv_hr (conv)."""
    from collections import Counter

    nf = upscaler.model.conv_hr.out_channels
    h, w = hw
    out = Counter()
    for n in emits:
        for c in upscaler.chunk_sizes(n, h, w):
            out[(c, h, w, nf, nf, True)] += 1
            out[(c, 2 * h, 2 * w, nf, nf, True)] += 1
            out[(c, 4 * h, 4 * w, nf, nf, False)] += 1
    return dict(out)


def face_landmarks(np, h: int, w: int, faces) -> list:
    """5-point landmarks of faces at (centre x, centre y, width, angle), the
    first three in fractions of the frame: the FFHQ template scaled to the
    face's width (its eyes 126 px apart at 512) and rotated."""
    from controlanimate_tpu_torch.models.face_align import FFHQ_TEMPLATE_512

    out = []
    for cx, cy, fw, angle in faces:
        c, s = math.cos(angle), math.sin(angle)
        pts = (FFHQ_TEMPLATE_512 - 256.0) * (fw * w / 512.0)
        pts = pts @ np.array([[c, s], [-s, c]], np.float32)
        out.append((pts + np.array([cx * w, cy * h], np.float32)).astype(np.float32))
    return out


# the face phase's faces, a frame: (centre x, centre y, width) in fractions of
# the frame, and the angle
FACES = ((0.3, 0.35, 0.45, 0.1), (0.72, 0.3, 0.3, -0.25), (0.55, 0.75, 0.18, 0.4))


def init_gfpgan_(torch, model, gen) -> None:
    """Seeded weights for a GFPGANv1Clean on its device: `init_weights_`,
    then each modulated conv's weight N(0, 1 / (C k k)) (its fan-in), the
    modulations' biases 1 (as upstream initialises them) and the noise
    weights 0.1."""
    init_weights_(torch, model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 5:
                p.normal_(0.0, 1.0 / math.sqrt(p[0, 0].numel()), generator=gen)
            elif name.endswith("modulation.bias"):
                p.fill_(1.0)
            elif p.ndim == 1 and name.endswith(".weight") and p.numel() == 1:
                p.fill_(0.1)


def gfpgan_checkpoint(torch, model) -> dict:
    """`model`'s weights in the GFPGANv1.3 release layout, on the CPU:
    `params_ema`, with the style MLP and the training-only `toRGB` heads an
    upstream checkpoint carries (the port's loader drops them)."""
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    style = model.num_style_feat
    for i in range(1, 17, 2):
        sd[f"stylegan_decoder.style_mlp.{i}.weight"] = torch.zeros(style, style)
        sd[f"stylegan_decoder.style_mlp.{i}.bias"] = torch.zeros(style)
    for i, block in enumerate(model.conv_body_up):
        c = block.conv2.out_channels
        sd[f"toRGB.{i}.weight"] = torch.zeros(3, c, 1, 1)
        sd[f"toRGB.{i}.bias"] = torch.zeros(3)
    return {"params_ema": sd}


def retinaface_checkpoint(torch, gen) -> dict:
    """A seeded detection_Resnet50_Final state dict in facexlib's layout, on
    the CPU: each conv without bias (lecun-normal) followed by a BatchNorm
    with its running statistics (weight 1 + N(0, 0.01), bias, mean N(0,
    0.01), var 1 + U(0, 0.1)), and the heads' biased 1x1 convs, the class
    head's weights 1e-4 of lecun-normal: its logits stay near its biases,
    so no anchor's score reaches 0.97 and the detector finds no face (with
    a lecun-normal class head it fires on many anchors, and the profile
    would restore dozens of faces a frame)."""
    from controlanimate_tpu_torch.models.retinaface import RetinaFaceNet

    with torch.device("meta"):
        folded = RetinaFaceNet().state_dict()

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=gen.device).mul_(std).cpu()

    def bn_name(conv: str) -> str:
        if conv == "body.conv1":
            return "body.bn1"
        if conv.endswith(".0"):  # downsample.0, fpn.*.0, ssh*.*.0
            return conv[:-2] + ".1"
        return conv[:-len("conv1")] + "bn" + conv[-1]  # body.layerL.B.convC

    sd = {}
    for key, t in folded.items():
        conv = key.rsplit(".", 1)[0]
        if key.endswith(".bias") and "Head" in key:
            sd[key] = randn(*t.shape, std=0.01)
        elif key.endswith(".weight"):
            gain = 1e-4 if key.startswith("ClassHead") else 1.0
            sd[key] = randn(*t.shape, std=gain / math.sqrt(t[0].numel()))
            if "Head" not in key:
                c, bn = t.shape[0], bn_name(conv)
                sd[f"{bn}.weight"] = 1.0 + randn(c, std=0.01)
                sd[f"{bn}.bias"] = randn(c, std=0.01)
                sd[f"{bn}.running_mean"] = randn(c, std=0.01)
                sd[f"{bn}.running_var"] = 1.0 + 0.1 * torch.rand(c, generator=gen,
                                                                 device=gen.device).cpu()
                sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    return sd


def small_face_reference(torch) -> dict:
    """The face step on the card against the CPU, same weights and noise: a
    tiny GFPGAN (out 64, style 32, narrow 1/8, seeded) and the
    real-architecture RetinaFace (seeded, BN folded) on a 96x80 frame with
    two faces given by landmarks. Gates, each in fp32 with TF32 off: the
    detector's three outputs within 1e-3 of their largest value; the
    aligned crops equal (the warp's float64 arithmetic is exact on both);
    the restored crops within 1 LSB (GFPGAN's convs sum in another order);
    the frame with both faces pasted into its 2x Lanczos4 resize within
    1 LSB."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch.models import face_align
    from controlanimate_tpu_torch.models.gfpgan import FaceEnhancer, GFPGANv1Clean, SeededNoise
    from controlanimate_tpu_torch.models.retinaface import (BGR_MEAN, RetinaFaceDetector,
                                                            RetinaFaceNet, fp32_convs,
                                                            retinaface_state_dict)

    gen = torch.Generator().manual_seed(SEED)
    gfp = GFPGANv1Clean(out_size=64, num_style_feat=32, narrow=0.125)
    init_gfpgan_(torch, gfp, gen)
    net = RetinaFaceNet()
    net.load_state_dict(retinaface_state_dict(retinaface_checkpoint(torch, gen)))
    noise = SeededNoise(SEED, "cpu")
    frame = synthetic_video(np, 1, 96, 80, SEED)[0]
    lms = face_landmarks(np, 96, 80, FACES[:2])
    out, sides = {}, {}
    for device in ("cpu", "cuda"):
        fe = FaceEnhancer(face_size=64, model=copy.deepcopy(gfp),
                          detector=RetinaFaceDetector(model=copy.deepcopy(net), device=device),
                          noise=_DeviceNoise(noise, device), device=device)
        f = torch.from_numpy(frame).to(device)
        x = (f.flip(-1).float() - torch.tensor(BGR_MEAN, device=device)).permute(2, 0, 1)[None]
        with torch.no_grad(), fp32_convs():
            heads = [t.cpu() for t in fe.detector.model(x)]
        crops = [face_align.align_face(f, lm, 64) for lm in lms]
        restored = [fe.restore_aligned(c) for c, _ in crops]
        fe.detect_landmarks = lambda frame, **kw: lms  # the faces are given
        pasted = fe.enhance(f, upscale=2.0)
        sides[device] = (heads, [c.cpu() for c, _ in crops], [r.cpu() for r in restored],
                         pasted.cpu())
    (h_cpu, c_cpu, r_cpu, p_cpu), (h_gpu, c_gpu, r_gpu, p_gpu) = sides["cpu"], sides["cuda"]
    out["detector_rel_err"] = max(float((a - b).abs().max() / a.abs().max())
                                  for a, b in zip(h_cpu, h_gpu))
    out["crop_max_lsb"] = max(int((a.int() - b.int()).abs().max()) for a, b in zip(c_cpu, c_gpu))
    out["restore_max_lsb"] = max(int((a.int() - b.int()).abs().max())
                                 for a, b in zip(r_cpu, r_gpu))
    diff = (p_cpu.int() - p_gpu.int()).abs()
    out["paste_max_lsb"], out["paste_mean_lsb"] = int(diff.max()), float(diff.float().mean())
    return out


class _DeviceNoise:
    """A `FaceNoise` drawn on the CPU and moved to `device`, so a CPU and a
    CUDA run see the same numbers."""

    def __init__(self, src, device):
        self.src, self.device = src, device

    def draw(self, number, shape):
        return self.src.draw(number, shape).to(self.device)


def time_face_steps(torch, np, fe, frames) -> dict:
    """The face step's stages on each (H, W, 3) uint8 card frame, timed by
    CUDA events: the detector (`detect_landmarks`, its readback included),
    then for each of the FACES, given by landmarks, the alignment, GFPGAN
    and the paste into the frame at 1x. Fails if a paste leaves the 16 x 16
    pixels around its face's centre unchanged or the frame goes
    non-finite. Returns each stage's ms summed over the frames, and the
    faces the detector found."""
    from controlanimate_tpu_torch.models.face_align import align_face, paste_face

    events = {"detect": [], "align": [], "gfpgan": [], "paste": []}

    def timed(stage, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        events[stage].append((a, b))
        return out

    found = 0
    for f in frames:
        found += len(timed("detect", lambda: fe.detect_landmarks(f)))
        bg = f.float()
        for lm in face_landmarks(np, f.shape[0], f.shape[1], FACES):
            crop, affine = timed("align", lambda: align_face(f, lm, fe.face_size))
            restored = timed("gfpgan", lambda: fe.restore_aligned(crop))
            pasted = timed("paste", lambda: paste_face(bg, restored, affine))
            cx, cy = (int(v) for v in lm.mean(0))
            if torch.equal(pasted[cy - 8:cy + 8, cx - 8:cx + 8], bg[cy - 8:cy + 8, cx - 8:cx + 8]):
                raise AssertionError(f"the paste left the face at ({cx}, {cy}) unchanged")
            bg = pasted
        if not bool(torch.isfinite(bg).all()):
            raise AssertionError("the face step made non-finite values")
    torch.cuda.synchronize()
    return {"ms": {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()},
            "faces_found": found}


def unet_k3_calls(unet, latent: int):
    """The K3 calls of one UNet forward on latent x latent maps, read off the
    module tree: a Counter of (N, C, heads) over the motion modules K3 takes."""
    from collections import Counter

    calls, hw = Counter(), latent

    def add(blk):
        for m in getattr(blk, "motion_modules", ()):
            if m.fusable:
                calls[(hw * hw, m.channels, m.heads)] += 1

    for blk in unet.down_blocks:
        add(blk)
        if hasattr(blk, "downsamplers"):
            hw //= 2
    add(unet.mid_block)
    for blk in unet.up_blocks:
        add(blk)
        if hasattr(blk, "upsamplers"):
            hw *= 2
    return calls


def expected_k3_launches(unet, latent: int, frames_n: int, steps: int, windows: int,
                         batch: int = 1) -> dict:
    """K3 launches by (B, F, N, C, heads) over `windows` windows of `steps`
    UNet forwards each, at `batch` (no CFG; the segments of a segment run)."""
    return {(batch, frames_n, n, c, h): k * steps * windows
            for (n, c, h), k in unet_k3_calls(unet, latent).items()}


@contextmanager
def env_set(name: str, value: str):
    """The environment variable `name` set to `value` inside, restored
    after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def motion_env(on: bool):
    """CONTROLANIMATE_PALLAS_MOTION, which the facade reads when a pipeline
    is built, set to 1 or 0 for the pipelines built inside, restored after."""
    from controlanimate_tpu_torch.pipelines.facade import MOTION_ENV

    return env_set(MOTION_ENV, "1" if on else "0")


def vae_k2_calls(vae, hw: tuple[int, int]) -> tuple:
    """The K2 calls of one VAE encode and one decode of an (H, W) image, read
    off the module tree: Counters of (H, W, Cin, Cout, affine, residual),
    each resnet giving conv1 (affine + SiLU) and conv2 (affine + SiLU +
    residual), each Upsample2D one call on the 2x map (no affine, no SiLU)."""
    from collections import Counter

    from controlanimate_tpu_torch.ops import conv_kernel as ck

    def resnets(blocks_and_hw):
        calls = Counter()
        for resnet, (h, w) in blocks_and_hw:
            for conv, res in ((resnet.conv1, False), (resnet.conv2, True)):
                if ck.supported(h, w, conv.in_channels, conv.out_channels):
                    calls[(h, w, conv.in_channels, conv.out_channels, True, res)] += 1
        return calls

    enc, (h, w), seen = vae.encoder, hw, []
    for blk in enc.down_blocks:
        seen += [(r, (h, w)) for r in blk.resnets]
        if hasattr(blk, "downsamplers"):
            h, w = h // 2, w // 2
    seen += [(r, (h, w)) for r in enc.mid_block.resnets]
    encode = resnets(seen)

    dec, (h, w) = vae.decoder, (hw[0] // 8, hw[1] // 8)
    seen, ups = [(r, (h, w)) for r in dec.mid_block.resnets], Counter()
    for blk in dec.up_blocks:
        seen += [(r, (h, w)) for r in blk.resnets]
        if hasattr(blk, "upsamplers"):
            h, w = 2 * h, 2 * w
            c = blk.upsamplers[0].conv
            ups[(h, w, c.in_channels, c.out_channels, False, False)] += 1
    return encode, resnets(seen) + ups


def expected_k2_launches(vae, hw, frames_n, overlap, full_windows, overlap_windows) -> dict:
    """K2 launches by (B, H, W, Cin, Cout, affine, residual) for native-LCM
    windows of `frames_n` frames: every window decodes all frames; a whole
    window encodes all, an overlap window only its new frames."""
    return vae_k2_launches(vae, hw, [frames_n] * (full_windows + overlap_windows),
                           [frames_n] * full_windows + [frames_n - overlap] * overlap_windows)


def vae_k2_launches(vae, hw, decodes, encodes) -> dict:
    """K2 launches by (B, H, W, Cin, Cout, affine, residual) of VAE decodes
    and encodes of (H, W) frames, `decodes` and `encodes` listing the frames
    each call takes."""
    from collections import Counter

    encode, decode = vae_k2_calls(vae, hw)
    out = Counter()
    for calls, batches in ((decode, decodes), (encode, encodes)):
        for key, n in calls.items():
            for frames in batches:
                out[(frames,) + key] += n
    return dict(out)


def synthetic_video(np, n: int, height: int, width: int, seed: int):
    """n seeded (height, width, 3) uint8 frames of moving gradients and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    frames = np.empty((n, height, width, 3), np.uint8)
    for i in range(n):
        base = np.stack([128 + 90 * np.sin((xx + 6 * i) / 37.0), 40 + 0.3 * yy + 2 * i,
                         128 + 80 * np.cos((xx + yy - 4 * i) / 53.0)], axis=-1)
        frames[i] = np.clip(base + rng.randn(height, width, 3) * 8, 0, 255)
    return frames


def init_weights_(torch, module, gen) -> None:
    """Seeded lecun-normal weights, zero biases, unit norm scales, in place on
    the module's device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


class HostNoise:
    """The default noise drawn on the CPU and moved to `device`, so a CPU and
    a CUDA run see the same numbers."""

    def __init__(self, seed: int, device):
        from controlanimate_tpu_torch.pipelines.engine import TorchNoise

        self.src, self.device = TorchNoise(seed, "cpu"), device

    def initial(self, shape):
        return self.src.initial(shape).to(self.device)

    def encode(self, shape):
        return self.src.encode(shape).to(self.device)

    def last_output(self, shape):
        return self.src.last_output(shape).to(self.device)

    def step(self, i, shape):
        return self.src.step(i, shape).to(self.device)


def build_models(torch, unet_cfg, vae_channels, clip_cfg, device, seed, vae_groups=32):
    """UNet, VAE and text stack with seeded random weights, made on `device`."""
    from controlanimate_tpu_torch.models.clip import CLIPTextModel
    from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
    from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel
    from controlanimate_tpu_torch.models.vae import AutoencoderKL
    from controlanimate_tpu_torch.pipelines.engine import EngineModels
    from controlanimate_tpu_torch.pipelines.facade import TextStack

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.device(device):
        unet = UNet3DConditionModel(unet_cfg)
        vae = AutoencoderKL(block_out_channels=vae_channels, groups=vae_groups)
        clip = CLIPTextModel(clip_cfg)
    for m in (unet, vae, clip):
        init_weights_(torch, m, gen)
    return EngineModels(unet=unet, vae=vae), TextStack(CLIPTokenizer.tiny(), clip)


def write_parallel(jobs: dict) -> dict:
    """Run each job (a name -> callable returning the bytes it wrote) on a
    thread of its own (copies to the host and file writes release the
    GIL); returns the bytes of each."""
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
    return {name: f.result() for name, f in futures.items()}


def write_snapshot(torch, root: Path, models, text, unet_json: dict, vae_json: dict,
                   motion: dict) -> dict:
    """A synthetic HF-layout snapshot of `models` and `text` under `root`:
    unet/ (the 2D keys), vae/, text_encoder/ (config.json + safetensors, in
    the modules' dtype) and tokenizer/ (the tokenizer's vocabulary and
    merges); and AnimateDiff motion checkpoints written by torch.save,
    `motion` mapping a file name to (with the mid block, positional-encoding
    length): the motion keys, plus each attention block's `pos_encoder.pe`
    table as AnimateDiff ships them. The weight files are written on threads.
    Returns the bytes of each file."""
    import shutil

    from controlanimate_tpu_torch.models.motion_module import temporal_positional_encoding
    from controlanimate_tpu_torch.weights.ingest import save_safetensors

    shutil.rmtree(root, ignore_errors=True)
    usd = models.unet.state_dict()
    c = text.model.config
    te_json = {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
               "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
               "intermediate_size": c.intermediate_size,
               "max_position_embeddings": c.max_position_embeddings,
               "layer_norm_eps": c.layer_norm_eps, "eos_token_id": c.eos_token_id}
    jobs = {}
    for name, cfg, sd, fname in (
            ("unet", unet_json, {k: v for k, v in usd.items() if "motion_modules" not in k},
             "diffusion_pytorch_model.safetensors"),
            ("vae", vae_json, models.vae.state_dict(), "diffusion_pytorch_model.safetensors"),
            ("text_encoder", te_json, text.model.state_dict(), "model.safetensors")):
        (root / name).mkdir(parents=True)
        (root / name / "config.json").write_text(json.dumps(cfg))
        jobs[f"{name}/{fname}"] = lambda path=root / name / fname, sd=sd: save_safetensors(
            path, sd)
    tok = text.tokenizer
    (root / "tokenizer").mkdir()
    (root / "tokenizer" / "vocab.json").write_text(json.dumps(tok.vocab))
    merges = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    (root / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))

    def save_motion(fname: str, mid: bool, pe_len: int) -> int:
        sd = {k: v.cpu() for k, v in usd.items()
              if "motion_modules" in k and (mid or not k.startswith("mid_block."))}
        for key in [k for k in sd if ".attention_blocks." in k and k.endswith(".to_q.weight")]:
            pe = temporal_positional_encoding(pe_len, sd[key].shape[0])
            sd[key.replace("to_q.weight", "pos_encoder.pe")] = torch.from_numpy(pe)[None].to(
                sd[key].dtype)
        torch.save(sd, root / fname)
        return (root / fname).stat().st_size

    for fname, (mid, pe_len) in motion.items():
        jobs[fname] = lambda f=fname, m=mid, n=pe_len: save_motion(f, m, n)
    return write_parallel(jobs)


def save_torch(torch, path: Path, obj) -> int:
    """torch.save of `obj` (its tensors copied to the host); returns the
    file's bytes."""
    host = {k: v.cpu() if hasattr(v, "cpu") else v for k, v in obj.items()}
    torch.save(host, path)
    return path.stat().st_size


def write_controlnets(torch, root: Path, nets: dict, annotator_files: dict) -> dict:
    """The ControlNets `nets` (name -> model) as diffusers folders under
    root/models/ControlNet/<last part of the name> (config.json with the
    architecture fields and a safetensors file, in the models' dtype), and
    the annotators' checkpoints `annotator_files` (file name, or a path
    below, -> state dict) under root/models/annotators/, where the port
    looks for them from the
    working directory `root`; the files written on threads. Returns the
    bytes of each file."""
    from controlanimate_tpu_torch.weights.ingest import save_safetensors

    jobs = {}
    for name, net in nets.items():
        c = net.config
        folder = root / "models" / "ControlNet" / name.split("/")[-1]
        folder.mkdir(parents=True)
        (folder / "config.json").write_text(json.dumps({
            "block_out_channels": list(c.block_out_channels),
            "layers_per_block": c.layers_per_block, "attention_head_dim": c.attention_heads,
            "cross_attention_dim": c.cross_attention_dim, "norm_num_groups": c.norm_num_groups,
            "down_block_types": [t.replace("3D", "2D") for t in c.down_block_types],
            "conditioning_embedding_out_channels": [
                net.controlnet_cond_embedding.conv_in.out_channels]
            + [b.out_channels for b in net.controlnet_cond_embedding.blocks[1::2]]}))
        path = folder / "diffusion_pytorch_model.safetensors"
        jobs[str(path.relative_to(root))] = lambda path=path, net=net: save_safetensors(
            path, net.state_dict())
    for fname, sd in annotator_files.items():
        path = root / "models" / "annotators" / fname
        path.parent.mkdir(parents=True, exist_ok=True)
        jobs[str(path.relative_to(root))] = lambda path=path, sd=sd: save_torch(torch, path, sd)
    return write_parallel(jobs)


def kohya_lora(torch, unet_sd: dict, te_sd: dict, gen, rank: int = 4) -> dict:
    """A synthetic LoRA in the Kohya layout (`lora_unet_...` / `lora_te_...`
    with `.lora_up.weight`, `.lora_down.weight` and `.alpha`, the layout of
    the LCM-LoRA release) on the projections of the UNet's cross-attention
    (attn2: to_q, to_k, to_v, to_out.0) and of the text encoder's
    self-attention (q, k, v, out_proj): lora_up N(0, 0.05^2), lora_down
    lecun-normal, alpha = rank; fp32 on the host."""
    lora = {}
    for prefix, sd, pattern in (
            ("lora_unet_", unet_sd, r"\.attn2\.(to_[qkv]|to_out\.0)\.weight$"),
            ("lora_te_", te_sd, r"\.self_attn\.(q|k|v|out)_proj\.weight$")):
        for key, w in sd.items():
            if not re.search(pattern, key):
                continue
            name = prefix + key[: -len(".weight")].replace(".", "_")
            out_f, in_f = w.shape
            lora[f"{name}.lora_up.weight"] = torch.randn(out_f, rank, generator=gen) * 0.05
            lora[f"{name}.lora_down.weight"] = (torch.randn(rank, in_f, generator=gen)
                                                / math.sqrt(in_f))
            lora[f"{name}.alpha"] = torch.tensor(float(rank))
    return lora


def write_frames(np, directory: Path, frames, start: int = 0) -> None:
    """Frames as PNGs numbered from start + 1 (a frame directory the loop
    reads without ffmpeg)."""
    from PIL import Image

    def save(i):
        Image.fromarray(np.asarray(frames[i])).save(directory / f"{start + i + 1:04d}.png",
                                                    compress_level=1)

    directory.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=4) as pool:  # zlib releases the GIL
        list(pool.map(save, range(len(frames))))


def read_frames(np, directory: Path) -> list:
    from PIL import Image

    return [np.asarray(Image.open(p).convert("RGB")) for p in sorted(directory.glob("*.png"))]


def small_disk_reference(torch, root: Path) -> dict:
    """A small bf16 pipeline built from disk on the card (a snapshot written
    under `root` from seeded weights, inference-v2.yaml) against the injected
    pipeline of the same weights on the card, same noise: the uint8
    difference (0 when the build read the weights it was given). Run by
    tests/test_torch_gpu.py; the `disk` phase checks the same at full width."""
    from controlanimate_tpu_torch.config import ArchConfig, RunConfig
    from controlanimate_tpu_torch.models.clip import CLIPTextConfig
    from controlanimate_tpu_torch.models.unet3d import UNet3DConfig
    from controlanimate_tpu_torch.pipelines.facade import ControlAnimatePipeline

    unet_json = {"block_out_channels": [80, 80, 160, 160], "layers_per_block": 1,
                 "attention_head_dim": 2, "cross_attention_dim": 32, "norm_num_groups": 8,
                 "time_cond_proj_dim": 8}
    vae_json = {"block_out_channels": [32, 64, 64, 512], "norm_num_groups": 8}
    arch = ArchConfig.from_yaml(INFERENCE_V2)
    ccfg = CLIPTextConfig(vocab_size=514, hidden_size=32, num_layers=2, num_heads=2,
                          intermediate_size=64, eos_token_id=513)
    models, text = build_models(torch, UNet3DConfig.from_arch(arch, unet_json),
                                tuple(vae_json["block_out_channels"]), ccfg, "cuda", SEED,
                                vae_groups=8)
    cfg = RunConfig(width=64, height=64, frame_count=4, overlap_length=2, use_lcm=True,
                    steps=2, strength=0.9, lcm_origin_steps=8, prompt="a (red fox)+",
                    dtype="bfloat16", pretrained_lcm_model_path=str(root),
                    inference_config_path=str(INFERENCE_V2),
                    motion_module=str(root / "mm.ckpt"), textual_inversion_paths=())
    injected = ControlAnimatePipeline(cfg, models=models, text_stack=text, arch=arch,
                                      device="cuda")
    write_snapshot(torch, root, models, text, unet_json, vae_json, {"mm.ckpt": (True, 32)})
    disk = ControlAnimatePipeline(cfg, device="cuda")
    frames = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED))
    out_injected = injected.animate(frames, None, seed=SEED)
    out_disk = disk.animate(frames, None, seed=SEED)
    diff = (out_injected.int() - out_disk.int()).abs()
    return {"max_lsb": int(diff.max()), "mean_lsb": float(diff.float().mean()),
            "config_equal": disk.models.unet.config == models.unet.config}


def small_models(torch, dtype: str, conv_kernel: bool):
    """The small pipeline's run config and its seeded models on the CPU: a
    2-level UNet (80 and 160 channels, 2 heads: head dims 40 and 80), a VAE
    whose mid block has 512 channels (128-channel levels with
    `conv_kernel`), and a 2-layer text model; 4 frames of 64x64, 2 LCM steps."""
    from controlanimate_tpu_torch.config import MotionModuleConfig, RunConfig
    from controlanimate_tpu_torch.models.clip import CLIPTextConfig
    from controlanimate_tpu_torch.models.unet3d import UNet3DConfig

    cfg = RunConfig(width=64, height=64, frame_count=4, overlap_length=2, use_lcm=True,
                    steps=2, strength=0.9, lcm_origin_steps=8, prompt="a (red fox)+",
                    dtype=dtype, use_pallas_conv=conv_kernel)
    ucfg = UNet3DConfig(
        block_out_channels=(80, 160), layers_per_block=1,
        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
        attention_heads=2, cross_attention_dim=32, norm_num_groups=8, time_cond_proj_dim=8,
        motion=MotionModuleConfig(num_attention_heads=2, temporal_position_encoding_max_len=8),
    )
    ccfg = CLIPTextConfig(vocab_size=514, hidden_size=32, num_layers=2, num_heads=2,
                          intermediate_size=64, eos_token_id=513)
    vae_channels = (128, 128, 128, 512) if conv_kernel else (32, 64, 64, 512)
    models, text = build_models(torch, ucfg, vae_channels, ccfg, "cpu", SEED, vae_groups=8)
    return cfg, models, text


def small_reference(torch, conv_kernel: bool = False, motion_kernel: bool = False,
                    controlnet: bool = False, windows: int = 2, unguided: bool = False,
                    **settings) -> dict:
    """The same small pipeline (fp32, same weights and noise) on the CPU and
    on the card: uint8 frames must agree within 1 LSB. Head dims 40/80 (UNet)
    and 512 (VAE) put K1 on the card's path; with `conv_kernel` the VAE's
    levels are 128 channels wide and `use_pallas_conv` is on, which puts K2
    on it too; with `motion_kernel` both pipelines are built with
    CONTROLANIMATE_PALLAS_MOTION=1, which puts the motion modules (80 and 160
    channels, 2 heads) on K3. `settings` replace the run config's (a
    multi-step sampler: `use_lcm` off, `scheduler`, `guidance_scale`, ...);
    without `use_lcm` and with `windows` 2 a second window follows, an
    overlap window at `overlap_strength` that starts from the first
    window's last two outputs. With `controlnet` one canny ControlNet of the
    UNet's down path (scale 1.0, guess mode off) steers the windows. With
    `unguided` the card also runs the first window at guidance 1.0 (the
    positive prompt alone, K3 off): `guidance_change_max` is its largest
    uint8 difference from the guided one."""
    import copy

    from controlanimate_tpu_torch.ops.canny import canny
    from controlanimate_tpu_torch.pipelines.engine import EngineModels
    from controlanimate_tpu_torch.pipelines.facade import ControlAnimatePipeline

    cfg, models, text = small_models(torch, "float32", conv_kernel)
    cfg = cfg.replace(**settings)
    if controlnet:
        cfg = cfg.replace(controlnets=("lllyasviel/sd-controlnet-canny",), cond_scale=(1.0,))
        models = EngineModels(unet=models.unet, vae=models.vae, annotators=[canny],
                              controlnets=seeded_controlnets(
                                  torch, models.unet.config, 1, "cpu",
                                  torch.Generator().manual_seed(SEED + 3)))
    with motion_env(motion_kernel):
        cpu = ControlAnimatePipeline(cfg, models=models, text_stack=text, device="cpu")
        gpu = ControlAnimatePipeline(cfg, models=copy.deepcopy(models),
                                     text_stack=copy.deepcopy(text), device="cuda")
    gen = torch.Generator().manual_seed(SEED)
    frames = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8, generator=gen)
    later = torch.cat([frames[-2:], torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                                                  generator=gen)])
    outs, seconds = [], {}
    for pipe, device in ((cpu, "cpu"), (gpu, "cuda")):
        t1 = time.perf_counter()
        out = pipe.animate(frames, None, seed=SEED, noise=HostNoise(SEED, device))
        outs.append([out.cpu()])
        if not cfg.use_lcm and windows == 2:
            outs[-1].append(pipe.animate(later, out[-2:], overlaps=2,
                                         strength=cfg.overlap_strength, seed=SEED, epoch=1,
                                         noise=HostNoise(SEED, device)).cpu())
        seconds[f"{device}_seconds"] = round(time.perf_counter() - t1, 3)
    diff = torch.stack([(a.int() - b.int()).abs() for a, b in zip(*outs)])
    if unguided:
        plain = ControlAnimatePipeline(cfg.replace(guidance_scale=1.0), models=gpu.models,
                                       text_stack=gpu.text, device="cuda")
        out = plain.animate(frames, None, seed=SEED, noise=HostNoise(SEED, "cuda")).cpu()
        seconds["guidance_change_max"] = int((out.int() - outs[1][0].int()).abs().max())
    return {"max_lsb": int(diff.max()), "mean_lsb": float(diff.float().mean()), **seconds}


class RecordedNoise:
    """A pipeline that draws its noise on the host (`HostNoise`) and keeps
    each window's frames (`animate` returns, on the CPU), for the segment
    checks."""

    def __init__(self, pipe):
        self.pipe, self.device, self.windows = pipe, pipe.device, []

    def animate(self, *args, seed, **kw):
        out = self.pipe.animate(*args, seed=seed, noise=HostNoise(seed, self.device), **kw)
        self.windows.append(out.cpu())
        return out


def small_segment_reference(torch, out_dir: Path = ROOT / "build" / "chip_smoke_segments",
                            card: str = "cuda", windows: int = 2) -> dict:
    """The small fp32 pipeline's segment-parallel loop (`parallel_segments`
    2; `windows` windows of 4 frames, overlap 2, a segment: 12 frames at 2
    windows, 8 at 1) on `card` against the same run on the CPU (same
    weights, host-drawn noise): each window's uint8 frames (both segments)
    within 1 LSB (`max_lsb`), and the frames written, whose stitch
    color-matches window 2 to window 1, as far apart (`frames_max_lsb`,
    reported). Then the sequential loop on `card` over each segment's first
    4 frames alone: its window against the segment run's first window of
    that segment (`sequential_max_lsb`), within 1 LSB (the parity contract
    of tests/test_vid2vid_e2e.py:538)."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch import vid2vid as v2v
    from controlanimate_tpu_torch.io.media import ArrayFrameSink, ArrayFrameSource
    from controlanimate_tpu_torch.pipelines.facade import ControlAnimatePipeline

    cfg, models, text = small_models(torch, "float32", False)
    cfg = cfg.replace(parallel_segments=2, checkpoint_interval=0, seed=SEED,
                      overlap_strength=0.85, ffmpeg_path=str(out_dir / "no-ffmpeg"))
    per = 4 + 2 * (windows - 1)  # a segment's frames
    frames = synthetic_video(np, 2 * per, 64, 64, SEED)
    runs, sinks = {}, {}
    for device in ("cpu", card):
        pipe = ControlAnimatePipeline(cfg, models=copy.deepcopy(models),
                                      text_stack=copy.deepcopy(text), device=device)
        runs[device], sinks[device] = RecordedNoise(pipe), ArrayFrameSink()
        summary = v2v.vid2vid(config=cfg.replace(output_video_dir=str(out_dir / device)),
                              pipeline=runs[device], frame_source=ArrayFrameSource(frames),
                              frame_sink=sinks[device])
        if summary["windows"] != windows or summary["segments"] != 2 or summary[
                "frames_written"] != len(frames):
            raise AssertionError(f"the small segment run on {device}: {summary}")
    card_pipe = runs[card].pipe
    window_diff = max(int((a.int() - b.int()).abs().max())
                      for a, b in zip(runs["cpu"].windows, runs[card].windows))
    frames_diff = np.abs(np.stack(sinks["cpu"].frames).astype(np.int16)
                         - np.stack(sinks[card].frames).astype(np.int16))
    seq_diff = 0
    for s in range(2):
        seq = RecordedNoise(card_pipe)
        v2v.vid2vid(config=cfg.replace(parallel_segments=0,
                                       output_video_dir=str(out_dir / f"sequential_{s}")),
                    pipeline=seq, frame_source=ArrayFrameSource(frames[per * s:per * s + 4]),
                    frame_sink=ArrayFrameSink())
        seq_diff = max(seq_diff, int((seq.windows[0].int()
                                      - runs[card].windows[0][s].int()).abs().max()))
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"max_lsb": window_diff, "frames_max_lsb": int(frames_diff.max()),
            "frames_mean_lsb": float(frames_diff.mean()), "sequential_max_lsb": seq_diff,
            "windows": len(runs[card].windows)}


# the cfg phase's profile: SampleConfig.yaml's sampler (with one canny
# ControlNet at 1.0 and K2 on) over one whole window, its 30 steps cut to
# 10 (the script's time limit; each step is the same work)
CFG_PROFILE = {"use_lcm": False, "scheduler": "EulerDiscreteScheduler", "steps": 10,
               "guidance_scale": 7.5, "strength": 1.0, "overlap_strength": 0.92}
# the disk phase's LCM-LoRA run: SampleConfigLCMLoRA.yaml's sampler
LCM_LORA_PROFILE = {"use_lcm": False, "scheduler": "LCMScheduler", "steps": 7,
                    "guidance_scale": 1.1, "strength": 1.0, "overlap_strength": 0.92}
# the disk phase's IP-Adapter run: SampleConfigIPAdapter.yaml's sampler,
# guess mode and adapter settings (checked against the shipped file), its
# files where the profile names them, from the snapshot root
IP_ADAPTER_PROFILE = {**LCM_LORA_PROFILE, "steps": 12, "guidance_scale": 1.35,
                      "guess_mode": True, "use_ipadapter": True, "ipa_scale": 0.65,
                      "do_initial_generation": True,
                      "ipadapter_image_encoder_path": "models/IP-Adapter/models/image_encoder",
                      "ipadapter_ckpt_path": "models/IP-Adapter/models/ip-adapter_sd15.bin"}
# the CLIP ViT-H/14 image encoder's self-attention (K1): (B, N, N, H, D)
VISION_K1_SHAPE = (1, 257, 257, 16, 80)
# the multi-step windows at 64x64 that tests/test_torch_gpu.py holds on the
# card against the CPU (two each): the default profile's Euler under CFG,
# the LCM-LoRA profile's tail, and DPM-Solver in three steps (its
# second-order update runs at the middle one; also the reference phase's
# window under CFG, with a ControlNet and K3)
EULER_CFG = {"use_lcm": False, "scheduler": "EulerDiscreteScheduler", "steps": 2,
             "strength": 1.0, "overlap_strength": 0.92, "guidance_scale": 7.5}
LCM_LORA = {**EULER_CFG, "scheduler": "LCMScheduler", "steps": 4, "guidance_scale": 1.1}
DPM_CFG = {**EULER_CFG, "scheduler": "DPMSolverMultistepScheduler", "steps": 3}


def init_hed_(torch, net, gen) -> None:
    """Seeded HED weights whose edge maps stay off 0 and 1 on 0..255 frames:
    the offset near the frames' mean, the first conv scaled down by 64,
    kernels N(0, 2/fan_in) (ReLU), projections N(0, 1/fan_in), biases
    N(0, 0.05^2); in place on the network's device."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name == "norm":
                p.copy_(torch.tensor([120.0, 110.0, 100.0]).reshape(1, 3, 1, 1))
            elif p.ndim == 4:
                gain = 1.0 if "projection" in name else 2.0
                p.normal_(0.0, math.sqrt(gain / p[0].numel()), generator=gen)
                if name == "block1.convs.0.weight":
                    p.div_(64.0)
            else:
                p.normal_(0.0, 0.05, generator=gen)


def edge_rich(np, frames):
    """`frames` with a hard-edged 32-px checkerboard added (the synthetic
    video is smooth: canny finds few edges in it)."""
    h, w = frames.shape[1:3]
    yy, xx = np.mgrid[0:h, 0:w]
    board = (((yy // 32 + xx // 32) % 2) * 70)[None, :, :, None]
    return np.clip(frames.astype(np.int16) + board, 0, 255).astype(np.uint8)


def canny_reference(torch, np, frames) -> dict:
    """Canny on the card against canny on the CPU on the same uint8 frames:
    the maps must be equal; returns the share of edge pixels."""
    from controlanimate_tpu_torch.ops.canny import canny

    host = torch.from_numpy(np.ascontiguousarray(frames))
    cpu = canny(host)
    card = canny(host.cuda()).cpu()
    if not torch.equal(cpu, card):
        raise AssertionError(f"canny on the card differs from the CPU in "
                             f"{int((cpu != card).sum())} values at {tuple(frames.shape)}")
    return {"shape": list(frames.shape), "edge_share": float(cpu[..., 0].mean())}


def small_hed_reference(torch) -> dict:
    """The full HED network (seeded by `init_hed_`) on 2 frames of 64x80 on
    the card and on the CPU, fp32: the maps' difference, and the uint8
    difference after the facade's quantisation (must be within 1 LSB)."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch.models.annotators.edge_nets import ControlNetHED, HEDAnnotator

    net = ControlNetHED()
    init_hed_(torch, net, torch.Generator().manual_seed(SEED))
    frames = torch.from_numpy(edge_rich(np, synthetic_video(np, 2, 64, 80, SEED)))
    cpu = HEDAnnotator(net)(frames)
    card = HEDAnnotator(copy.deepcopy(net).cuda())(frames.cuda()).cpu()
    q = lambda m: (m * 255.0 + 0.5).to(torch.uint8).int()  # noqa: E731
    return {"max_abs_err": float((cpu - card).abs().max()),
            "max_lsb": int((q(cpu) - q(card)).abs().max()), "std": float(cpu.std())}


def annotator_card_vs_cpu(torch, np, cpu_ann, card_ann, sizes, n: int) -> tuple:
    """Two annotators on the same `n` uint8 frames (`edge_rich` synthetic
    video) at each (h, w) of `sizes`, one on the CPU, one on the card: (the
    largest difference in LSB after the facade's quantisation (a map
    outside [0, 1] goes to 0 or 255), the largest abs difference, [mean,
    std] of each CPU map); a map of another shape than the frames fails."""
    q = lambda m: (m.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).int()  # noqa: E731
    lsb, err, stats = 0, 0.0, []
    for h, w in sizes:
        frames = torch.from_numpy(edge_rich(np, synthetic_video(np, n, h, w, SEED)))
        cpu = cpu_ann(frames)
        card = card_ann(frames.cuda()).cpu()
        if card.shape != (n, h, w, 3):
            raise AssertionError(f"an annotator's map at {h}x{w} is {tuple(card.shape)}")
        lsb = max(lsb, int((q(cpu) - q(card)).abs().max()))
        err = max(err, float((cpu - card).abs().max()))
        stats.append([float(cpu.mean()), float(cpu.std())])
    return lsb, err, stats


def small_normalbae_reference(torch) -> dict:
    """The full B5 NormalBae (`normalbae_checkpoint` made on the card, its
    statistics from the 64x80 frames; folded once on the host, a copy on
    the card) in fp32 on the card against the CPU on 2 frames at 64x80 and
    at 45x61 (odd sides: the network's 46x62 cut to the frame): within 1
    LSB after the facade's quantisation; the maps' [mean, std] and each
    channel's smallest std."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch.models.annotators.normalbae import NormalBaeAnnotator
    from controlanimate_tpu_torch.models.annotators.seeded import (normalbae_checkpoint,
                                                                   normalbae_model)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    ckpt = normalbae_checkpoint(gen, torch.from_numpy(
        edge_rich(np, synthetic_video(np, 2, 64, 80, SEED))))
    cpu = NormalBaeAnnotator(normalbae_model(ckpt, "cpu"))
    card = NormalBaeAnnotator(copy.deepcopy(cpu.model).cuda())
    lsb, err, stats = annotator_card_vs_cpu(torch, np, cpu, card, ((64, 80), (45, 61)), 2)
    return {"max_lsb": lsb, "max_abs_err": err, "mean_std": stats,
            "params": sum(p.numel() for p in cpu.model.parameters())}


# the reference phase's depth networks: Intel widths, their ViTs cut (the
# plain net's four taps need four layers), position tables for 128x128
DEPTH_REF_SIZE = 128
DEPTH_REF_LAYERS = {"plain": (4, (0, 1, 2, 3)), "hybrid": (2, (2, 5, 0, 1))}


def small_depth_reference(torch) -> dict:
    """The full-width plain DPT (4 of its 24 ViT layers) and DPT-hybrid (2
    of 12), seeded on the card (`seeded.dpt_checkpoint`,
    `dpt_hybrid_checkpoint`: position tables for a 128x128 input, heads
    calibrated on the frame), each on one 128x128 frame, and GLPN at the
    MiT-b0 widths (`seeded.glpn_checkpoint`, every stage's attention on K1
    at head dim 32) on one GLPN_REF_HW frame, in fp32 on the card against
    the CPU: the largest difference over the largest value (must be within
    1e-4), each map's std, and GLPN's K1 launches on the card by shape."""
    import dataclasses

    import numpy as np

    from controlanimate_tpu_torch.models.annotators import depth, seeded
    from controlanimate_tpu_torch.models.annotators.dpt import DPT_LARGE
    from controlanimate_tpu_torch.models.annotators.dpt_hybrid import DPT_HYBRID_MIDAS
    from controlanimate_tpu_torch.models.annotators.glpn import GLPN_B0
    from controlanimate_tpu_torch.ops import flash_attention as fa
    from controlanimate_tpu_torch.ops.warp import fp32_convs

    size = DEPTH_REF_SIZE
    frames = torch.from_numpy(edge_rich(np, synthetic_video(np, 1, size, size, SEED)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = {}
    for kind, make, full in (("plain", seeded.dpt_checkpoint, DPT_LARGE),
                             ("hybrid", seeded.dpt_hybrid_checkpoint, DPT_HYBRID_MIDAS)):
        layers, taps = DEPTH_REF_LAYERS[kind]
        cfg = dataclasses.replace(full, num_layers=layers, taps=taps)
        config, sd = make(gen, frames, cfg, size)
        maps = {}
        for device in ("cpu", "cuda"):
            net = depth.depth_network(config, sd, device, size)
            with torch.no_grad(), fp32_convs():
                maps[device] = net(depth.network_input(frames.to(device), size)).cpu()
        largest = float(maps["cpu"].abs().max())
        out[kind] = {"err_over_largest": float((maps["cuda"] - maps["cpu"]).abs().max()) / largest,
                     "largest": largest, "std": float(maps["cpu"].std()),
                     "params": sum(v.numel() for v in sd.values())}
    frames = torch.from_numpy(edge_rich(np, synthetic_video(np, 1, *GLPN_REF_HW, SEED)))
    config, sd = seeded.glpn_checkpoint(gen, frames, GLPN_B0)
    x = depth.glpn_input(frames)
    maps = {}
    for device in ("cpu", "cuda"):
        net = depth.depth_network(config, sd, device)
        before = Counter(fa.flash_attention.launches_by_shape)
        with torch.no_grad(), fp32_convs():
            maps[device] = net(x.to(device)).cpu()
    k1 = Counter(fa.flash_attention.launches_by_shape) - before
    largest = float(maps["cpu"].abs().max())
    out["glpn"] = {"err_over_largest": float((maps["cuda"] - maps["cpu"]).abs().max()) / largest,
                   "largest": largest, "std": float(maps["cpu"].std()),
                   "params": sum(v.numel() for k, v in sd.items()
                                 if not k.endswith("num_batches_tracked")),
                   "k1_launches": {str(k): n for k, n in sorted(k1.items())}}
    return out


def small_annotator_reference(torch) -> dict:
    """Lineart, MLSD, softedge and lineart_anime on the card against the
    CPU, fp32, on the same uint8 frames with seeded weights
    (`annotators/seeded.py`): lineart on 2 frames at 64x80, within 1 LSB
    after the facade's uint8 quantisation; PidiNet (its classifier set on
    those frames) on 2 frames at 64x80 (both at 48x96 too in
    tests/test_torch_gpu.py), the full-width lineart_anime on a frame at
    200x120
    (both cubic resizes; the network runs at 256x256), each within 1 LSB
    likewise;
    MLSD (`mlsd_checkpoint`, made and its head set on the card) on 2 frames
    of 64x80: each tpMap channel within 1e-3 of its RMS, and the map the
    card decodes and draws from its tpMap equal to the CPU's decode and
    drawing of that same tpMap; INTER_AREA at 768x512 -> 512x512 and 1024x1024 -> 512x512,
    and 3 canvases of 200 random segments (ends in [-300, 800)), card
    against CPU: equal."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch.models.annotators import mlsd
    from controlanimate_tpu_torch.models.annotators.edge_nets import (LineartAnnotator,
                                                                     LineartGenerator)
    from controlanimate_tpu_torch.models.annotators.lineart_anime import (LineartAnimeAnnotator,
                                                                          UnetGenerator)
    from controlanimate_tpu_torch.models.annotators.pidinet import PidiNetAnnotator
    from controlanimate_tpu_torch.models.annotators.seeded import (
        mlsd_checkpoint, mlsd_model, pidinet_checkpoint, pidinet_model, seed_lineart_,
        seed_lineart_anime_)
    from controlanimate_tpu_torch.ops.draw import lines
    from controlanimate_tpu_torch.ops.resize import resize_area

    t0 = time.perf_counter()

    def card_vs_cpu(cpu_ann, card_ann, sizes, n):
        return annotator_card_vs_cpu(torch, np, cpu_ann, card_ann, sizes, n)

    net = seed_lineart_(LineartGenerator(), torch.Generator().manual_seed(SEED))
    lsb, _, stats = card_vs_cpu(LineartAnnotator(net), LineartAnnotator(copy.deepcopy(net).cuda()),
                                ((64, 80),), 2)
    std = [sd for _, sd in stats]
    pidi_ckpt = pidinet_checkpoint(torch.Generator().manual_seed(SEED), torch.from_numpy(
        edge_rich(np, synthetic_video(np, 2, 64, 80, SEED))))
    pidi = card_vs_cpu(PidiNetAnnotator(pidinet_model(pidi_ckpt, "cpu")),
                       PidiNetAnnotator(pidinet_model(pidi_ckpt, "cuda")), ((64, 80),), 2)
    # the full-width lineart_anime seeded on the card (54 M parameters), a
    # copy on the CPU; at 200x120 the network runs at 256x256 between the
    # two cubic resizes
    agen = torch.Generator(device="cuda")
    agen.manual_seed(SEED)
    with torch.device("cuda"):
        anime_net = seed_lineart_anime_(UnetGenerator(), agen)
    anime = card_vs_cpu(LineartAnimeAnnotator(copy.deepcopy(anime_net).cpu()),
                        LineartAnimeAnnotator(anime_net), ((200, 120),), 1)
    frames = torch.from_numpy(edge_rich(np, synthetic_video(np, 2, 64, 80, SEED)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sd = mlsd_checkpoint(gen, frames)
    tp_cpu = mlsd.MLSDAnnotator(mlsd_model(sd, "cpu")).tp_map(frames)
    tp_card = mlsd.MLSDAnnotator(mlsd_model(sd, "cuda")).tp_map(frames.cuda())
    rms = tp_cpu.pow(2).mean((0, 2, 3)).sqrt()
    err = (tp_cpu - tp_card.cpu()).abs().amax((0, 2, 3))
    drawn_cpu = mlsd.draw_segments(tp_card.cpu())
    drawn_card = mlsd.draw_segments(tp_card).cpu()
    resize_diff = 0
    for h, w in ((768, 512), (1024, 1024)):
        video = torch.from_numpy(synthetic_video(np, 2, h, w, SEED))
        resize_diff += int((resize_area(video, 512, 512)
                            != resize_area(video.cuda(), 512, 512).cpu()).sum())
    ends = torch.randint(-300, 800, (3, 200, 4), generator=torch.Generator().manual_seed(SEED))
    keep = torch.ones(3, 200, dtype=torch.bool)
    line_diff = int((lines(ends[..., :2], ends[..., 2:], keep, 512, 512) != lines(
        ends[..., :2].cuda(), ends[..., 2:].cuda(), keep.cuda(), 512, 512).cpu()).sum())
    return {"lineart_max_lsb": lsb, "lineart_std": std,
            "softedge_max_lsb": pidi[0], "softedge_max_abs_err": pidi[1],
            "softedge_mean_std": pidi[2], "lineart_anime_max_lsb": anime[0],
            "lineart_anime_max_abs_err": anime[1], "lineart_anime_mean_std": anime[2],
            "mlsd_tp_max_abs_err": float(err.max()),
            "mlsd_tp_err_over_rms": float((err / rms).max()),
            "mlsd_draw_diff": int((drawn_cpu != drawn_card).sum()),
            "mlsd_drawn_share": float((drawn_cpu > 0).float().mean()),
            "resize_area_diff": resize_diff, "line_diff": line_diff,
            "seconds": round(time.perf_counter() - t0, 3)}


def openpose_annotator(torch, sds: dict, device):
    """The OpenPose annotator of `openpose_checkpoints` state dicts on
    `device`."""
    from controlanimate_tpu_torch.models.annotators import openpose as op
    from controlanimate_tpu_torch.models.annotators.openpose_face import FaceNet
    from controlanimate_tpu_torch.models.annotators.openpose_hand_face import HandPoseNet

    nets = []
    for make, fname in zip((op.BodyPoseNet, HandPoseNet, FaceNet), op.WEIGHT_NAMES):
        with torch.device("meta"):
            net = make()
        net.load_state_dict({k: v.to(device) for k, v in sds[fname].items()}, assign=True)
        nets.append(net)
    return op.OpenPoseAnnotator(*nets)


def small_openpose_reference(torch, card: str = "cuda") -> dict:
    """OpenPose on the card against the CPU, with the seeded networks
    (`openpose_checkpoints`, made on the card): the body, hand and face
    networks on one 128x128 input, each output channel within 1e-3 of its
    RMS; the crafted
    maps of two people at 384x256 (`pose_maps`) through INTER_CUBIC, the
    filter, the peaks, the limbs, the people and the drawing on the card,
    equal to the CPU's; the hand and face heat maps of those people's boxes
    made on the card, decoded and drawn on the card and on the CPU: equal
    canvases, at least one hand and one face drawn; and INTER_CUBIC (uint8
    768x512 -> 184x128 and a 61x61 crop -> 368x368, float32 23x16x19 ->
    768x512) and the Gaussian filter (random and plateau maps) on the card
    equal to the CPU's. `card` names the device ("cpu" rehearses it)."""
    import numpy as np

    from controlanimate_tpu_torch.models.annotators import openpose as op
    from controlanimate_tpu_torch.models.annotators.openpose_face import (
        FACE_PARTS, face_regions_from_body, face_shapes)
    from controlanimate_tpu_torch.models.annotators.openpose_hand_face import (
        HAND_PARTS, crop_boxes, crop_heat, hand_regions_from_body, hand_shapes, heat_peaks)
    from controlanimate_tpu_torch.models.annotators.seeded import (openpose_checkpoints,
                                                                  pose_maps)
    from controlanimate_tpu_torch.ops.gaussian import gaussian_filter
    from controlanimate_tpu_torch.ops.resize import resize_cubic
    from controlanimate_tpu_torch.ops.warp import fp32_convs

    t0 = time.perf_counter()
    gen = torch.Generator(device=card)
    gen.manual_seed(SEED)
    sds = openpose_checkpoints(gen)
    ann_card, ann_cpu = (openpose_annotator(torch, sds, card),
                         openpose_annotator(torch, sds, "cpu"))
    del sds
    ratios = {}
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(SEED)) - 0.5
    with torch.no_grad(), fp32_convs():
        for name in ("body", "hand", "face"):
            got, want = (getattr(a, name)(t) for a, t in ((ann_card, x.to(card)), (ann_cpu, x)))
            for i, (g, w) in enumerate(zip(*((got, want) if name == "body"
                                             else ((got,), (want,))))):
                dims = (0, 2, 3)  # each output channel
                rms = w.pow(2).mean(dims).sqrt()
                ratios[f"{name}_{i}"] = float(((g.cpu() - w).abs().amax(dims) / rms).max())
    # the body decode and drawing of crafted maps, card against CPU
    H, W = 384, 256
    frame = torch.from_numpy(synthetic_video(np, 1, H, W, SEED + 2))
    h8, w8 = op.body_input_size(H, W)
    heat8, paf8 = pose_maps(H, W, h8 // 8, w8 // 8)
    decoded = {}
    for dev in (card, "cpu"):
        peaks = op.peak_lists(torch.from_numpy(heat8[None]).to(dev), H, W)
        conns = op.limb_connections(torch.from_numpy(paf8[None]).to(dev), peaks, H, W)
        candidate, subset = op.assemble_people(peaks[0], *conns[0])
        shapes = op.body_shapes(candidate, subset)
        decoded[dev] = (candidate, subset, shapes,
                        op.paint_shapes([shapes], H, W, dev)[0].cpu())
    candidate, subset, body, canvas = decoded[card]
    body_equal = bool(np.array_equal(candidate, decoded["cpu"][0])
                      and np.array_equal(subset, decoded["cpu"][1])
                      and torch.equal(canvas, decoded["cpu"][3]))
    # the hands' and faces' heat from the card, decoded on both
    hand_boxes = [(0, *b) for b in hand_regions_from_body(candidate, subset, H, W)]
    face_boxes = [(0, *b, False) for b in face_regions_from_body(candidate, subset, H, W)]
    frame_card = frame.to(card)
    heats = (crop_heat(ann_card.hand, frame_card, crop_boxes(frame.shape, hand_boxes)[1]),
             crop_heat(ann_card.face, frame_card, crop_boxes(frame.shape, face_boxes)[1]))
    drawn, canvases = {}, {}
    for dev in (card, "cpu"):
        hand_pk, face_pk = (heat_peaks(hs.to(dev), np.array([b[3] for b in boxes]), parts)
                            .cpu().numpy()
                            for hs, boxes, parts in ((heats[0], hand_boxes, HAND_PARTS),
                                                     (heats[1], face_boxes, FACE_PARTS)))
        hands = [hand_shapes(pk, b[1:]) for pk, b in zip(hand_pk, hand_boxes)]
        faces = [face_shapes(pk, b[1:4]) for pk, b in zip(face_pk, face_boxes)]
        drawn[dev] = (sum(bool(h) for h in hands), sum(bool(f) for f in faces))
        shapes = body + [s for h in hands for s in h] + [s for f in faces for s in f]
        canvases[dev] = op.paint_shapes([shapes], H, W, dev)[0].cpu()
    # the operations alone
    rng = np.random.RandomState(SEED)
    ops_diff = 0
    u8 = torch.from_numpy(synthetic_video(np, 2, 768, 512, SEED + 1))
    crop = u8[:1, 100:161, 200:261].contiguous()
    maps = torch.from_numpy(rng.randn(2, 23, 16, 19).astype(np.float32))
    smooth = torch.from_numpy(np.stack([rng.rand(200, 300), np.round(rng.rand(200, 300) * 4) / 4])
                              .astype(np.float32))
    for fn, arg in ((lambda t: resize_cubic(t, 184, 128), u8),
                    (lambda t: resize_cubic(t, 368, 368), crop),
                    (lambda t: resize_cubic(t, 768, 512), maps), (gaussian_filter, smooth)):
        ops_diff += int((fn(arg) != fn(arg.to(card)).cpu()).sum())
    return {"net_err_over_rms": ratios, "people": int(len(subset)),
            "body_equal": body_equal, "hands_faces_drawn": drawn[card],
            "canvas_diff": int((canvases[card] != canvases["cpu"]).sum()),
            "drawn_share": float((canvases[card] > 0).any(-1).float().mean()),
            "ops_diff": ops_diff, "seconds": round(time.perf_counter() - t0, 3)}


def seeded_controlnets(torch, unet_cfg, n: int, device, gen) -> list:
    """`n` ControlNets of `unet_cfg`'s down path, seeded by `init_weights_`
    (the zero-conv heads then are not zero), made on `device`."""
    from dataclasses import replace

    from controlanimate_tpu_torch.models.controlnet import ControlNetModel

    with torch.device(device):
        nets = [ControlNetModel(replace(unet_cfg, use_motion_module=False)) for _ in range(n)]
    for net in nets:
        init_weights_(torch, net, gen)
        heads = list(net.controlnet_down_blocks) + [net.controlnet_mid_block]
        if not all(bool(h.weight.abs().sum()) for h in heads):
            raise AssertionError("a ControlNet head is zero: its residual would prove nothing")
    return nets


def small_controlnet_reference(torch) -> dict:
    """The small pipeline of `small_reference` (fp32) with two ControlNets of
    its UNet's down path, canny at 1.0 and HED (`init_hed_`) at 0.5, on the
    CPU and on the card with the same weights and noise, on edge-rich frames:
    the uint8 frames must agree within 1 LSB, and differ from the window
    without ControlNets."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch.models.annotators.edge_nets import ControlNetHED, HEDAnnotator
    from controlanimate_tpu_torch.ops.canny import canny
    from controlanimate_tpu_torch.pipelines.engine import EngineModels
    from controlanimate_tpu_torch.pipelines.facade import ControlAnimatePipeline

    cfg, models, text = small_models(torch, "float32", False)
    cfg = cfg.replace(controlnets=("lllyasviel/sd-controlnet-canny",
                                   "lllyasviel/sd-controlnet-hed"), cond_scale=(1.0, 0.5))
    nets = seeded_controlnets(torch, models.unet.config, 2, "cpu",
                              torch.Generator().manual_seed(SEED + 1))
    hed = ControlNetHED()
    init_hed_(torch, hed, torch.Generator().manual_seed(SEED + 2))
    frames = torch.from_numpy(edge_rich(np, synthetic_video(np, 4, 64, 64, SEED)))
    outs = {}
    for device in ("cpu", "cuda"):
        m = models if device == "cpu" else copy.deepcopy(models)
        pipe = ControlAnimatePipeline(
            cfg, models=EngineModels(
                unet=m.unet, vae=m.vae,
                controlnets=nets if device == "cpu" else copy.deepcopy(nets),
                annotators=[canny, HEDAnnotator(copy.deepcopy(hed).to(device))]),
            text_stack=text if device == "cpu" else copy.deepcopy(text), device=device)
        outs[device] = pipe.animate(frames, None, seed=SEED, noise=HostNoise(SEED, device)).cpu()
    plain = ControlAnimatePipeline(cfg.replace(controlnets=(), cond_scale=()), models=models,
                                   text_stack=text, device="cpu")
    out_plain = plain.animate(frames, None, seed=SEED, noise=HostNoise(SEED, "cpu"))
    diff = (outs["cpu"].int() - outs["cuda"].int()).abs()
    return {"max_lsb": int(diff.max()), "mean_lsb": float(diff.float().mean()),
            "controlnet_change_max": int((outs["cpu"].int() - out_plain.int()).abs().max())}


def device_activities(prof) -> tuple:
    """The card's activities (kernels and copies) that `prof` (a finished
    torch.profiler run) recorded, summed from its raw event list by name:
    (ns by name, count by name). Raises when it recorded no device time."""
    from collections import Counter

    from torch.autograd import DeviceType

    device_ns, launches = Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device_ns[e.name()] += e.duration_ns()
            launches[e.name()] += 1
    if sum(device_ns.values()) <= 0:
        raise AssertionError("the profiler recorded no device time")
    return device_ns, launches


def profile_window(torch, run, unprofiled_seconds: float) -> dict:
    """One call of `run` (a window) under torch.profiler, recording the
    card's activity only: the device activities' summed time (one stream, so
    they do not overlap), the device's idle share of the same window run
    without the profiler (`unprofiled_seconds`), the ten kernels with the
    most device time and K1's share of the device time. The profiler's raw
    event list is summed directly: its per-op tables (`key_averages`) take
    seconds to build for a window's twenty thousand launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    device_ns, launches = device_activities(prof)
    busy_ns = sum(device_ns.values())
    k1_ns = sum(ns for name, ns in device_ns.items() if "attn_" in name)
    return {
        "profiled_window_seconds": round(seconds, 4),
        "unprofiled_window_seconds": round(unprofiled_seconds, 4),
        "device_busy_ms": busy_ns / 1e6,
        "device_idle_share": 1.0 - busy_ns / 1e9 / unprofiled_seconds,
        "device_activities": sum(launches.values()),
        "k1_ms": k1_ns / 1e6, "k1_share_of_busy": k1_ns / busy_ns,
        "top10": [{"kernel": name[:120], "ms": ns / 1e6, "count": launches[name]}
                  for name, ns in device_ns.most_common(10)],
    }


def warm_profiler(torch) -> float:
    """One tiny profiled call on the card, so that later profiles do not pay
    torch.profiler's start (CUPTI's); returns its seconds."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_busy_ms(torch, fn, iters: int = 3) -> float:
    """The card's summed activity time (kernels and copies; one stream, so
    they do not overlap) of one call of `fn`, by torch.profiler over `iters`
    calls after a warm-up: its time on the card without the waits for the
    host that a CUDA-event time includes when the host launches slower than
    the card runs. A profile that recorded no device time at all (the
    profiler now and then drops a short run's activity, at times several
    runs in a row) is taken again after a pause, five times in all before
    it fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    attempts = 5
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        try:
            return sum(device_activities(prof)[0].values()) / 1e6 / iters
        except AssertionError:
            if attempt == attempts - 1:
                raise
            time.sleep(1.0)


@contextmanager
def plain_attention(attention_module, plain):
    """Route the main path's K1 calls to the plain version (comparison only)."""
    kernel = attention_module.flash_attention
    attention_module.flash_attention = plain
    try:
        yield
    finally:
        attention_module.flash_attention = kernel


def expected_k1_launches(full_windows: int, overlap_windows: int, steps: int,
                         frames_n: int, overlap: int, latent=(64, 64),
                         controlnets: int = 0, batch: int = 1, decode_chunk: int = 0) -> dict:
    """K1 launches by shape that windows of `batch` segments on `latent` (h,
    w) imply: the UNet's self-attention `steps` times a window at B*F =
    batch * frames_n, each ControlNet's (its down and mid path) as often,
    one VAE mid-block attention in the decode (all B*F frames, or
    `decode_chunk` frames a pass) and one in the encode (all frames, or only
    the new ones when the overlap latents are reused)."""
    from collections import Counter

    windows, bf = full_windows + overlap_windows, batch * frames_n
    expected = Counter({shape: n * steps * windows
                        for shape, n in unet_k1_shapes(bf, latent).items()})
    n = latent[0] * latent[1]
    for div, D, blocks in CONTROLNET_LEVELS:
        expected[(bf, n // div, n // div, 8, D)] += controlnets * blocks * steps * windows
    # the VAE's mid block sees the latent grid with one head of 512
    chunk = decode_chunk or bf
    expected[(chunk, n, n, 1, 512)] += windows * (bf // chunk)
    expected[(bf, n, n, 1, 512)] += full_windows
    if overlap_windows:
        expected[(batch * (frames_n - overlap), n, n, 1, 512)] += overlap_windows
    return {shape: k for shape, k in expected.items() if k}


def expected_cfg_k1_launches(window_steps: list, frames_n: int, encodes: list,
                             latent=(64, 64), controlnets: int = 0, guess_mode: bool = False,
                             embeds: int = 0) -> dict:
    """K1 launches by shape of windows under classifier-free guidance
    (guidance > 1) on `latent` (h, w): the UNet's self-attention on the
    doubled batch (B*F = 2 * frames_n) once a step, `window_steps` holding
    each window's steps, and each ControlNet's as often, on the doubled
    batch or in guess mode on the positive half alone (B*F = frames_n); one
    VAE mid-block attention in each window's decode (all frames) and one in
    each encode (`encodes`: the frames each encode takes); the CLIP image
    encoder's 32 layers in each of `embeds` IP-Adapter anchor embeds."""
    from collections import Counter

    steps, bf = sum(window_steps), 2 * frames_n
    expected = Counter({shape: n * steps for shape, n in unet_k1_shapes(bf, latent).items()})
    n = latent[0] * latent[1]
    cn_bf = frames_n if guess_mode else bf
    for div, D, blocks in CONTROLNET_LEVELS:
        expected[(cn_bf, n // div, n // div, 8, D)] += controlnets * blocks * steps
    if embeds:
        expected[VISION_K1_SHAPE] += 32 * embeds
    expected[(frames_n, n, n, 1, 512)] += len(window_steps)
    for frames in encodes:
        expected[(frames, n, n, 1, 512)] += 1
    return dict(expected)


def variant_k1_launches(full_windows: int, overlap_windows: int, steps: int, frames_n: int,
                        overlap: int, latent=(64, 64)) -> dict:
    """K1 launches by shape of windows of a UNet with sparse-causal
    self-attention and the temporal sub-layer on `latent` (h, w), as
    `expected_k1_launches` counts them but for each spatial block's two
    attentions: attn1 at (B*F, N, 2N, 8, D) (frame 0 and the frame before as
    keys) and attn_temp at (N, F, F, 8, D) (the frames of each token)."""
    expected = Counter(expected_k1_launches(full_windows, overlap_windows, steps, frames_n,
                                            overlap, latent))
    for (bf, n, _, heads, d), blocks in unet_k1_shapes(frames_n, latent).items():
        k = blocks * steps * (full_windows + overlap_windows)
        expected[(bf, n, n, heads, d)] -= k
        expected[(bf, n, 2 * n, heads, d)] += k
        expected[(n, frames_n, frames_n, heads, d)] += k
    return {shape: k for shape, k in expected.items() if k}


def variant_unet(torch, unet, band: int, gen):
    """`unet` rebuilt with the inference yaml's two attention options
    (sparse-causal self-attention, the temporal sub-layer) and motion band
    `band`, in its dtype on its device: every weight copied from `unet` but
    the sub-layer's `attn_temp` and `norm_temp`, which are seeded
    (`init_weights_`: its out projection not zero, so the sub-layer is no
    identity)."""
    from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel

    cfg = unet.config
    vcfg = dataclasses.replace(cfg, cross_frame_attention=True, temporal_attention=True,
                               motion=dataclasses.replace(cfg.motion, attention_band=band))
    weight = next(unet.parameters())
    with torch.device(weight.device):
        var = UNet3DConditionModel(vcfg).to(weight.dtype)
    missing, unexpected = var.load_state_dict(unet.state_dict(), strict=False)
    if unexpected or not missing or any("_temp." not in k for k in missing):
        raise AssertionError(f"the variant UNet's keys differ from the UNet's beyond the "
                             f"sub-layer: {missing[:3]}, {unexpected[:3]}")
    for m in var.modules():
        if getattr(m, "attn_temp", None) is not None:
            init_weights_(torch, m.attn_temp, gen)
            init_weights_(torch, m.norm_temp, gen)
    return var.eval()


def set_motion_band(unet, band: int) -> None:
    """`unet` as its config builds it with motion band `band`, the weights
    kept: the band of each motion module and frame attention, and of the
    config, which the facade holds against `temporal_band`."""
    for m in unet.modules():
        if hasattr(m, "band"):
            m.band = band
    unet.config = dataclasses.replace(
        unet.config, motion=dataclasses.replace(unet.config.motion, attention_band=band))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from controlanimate_tpu_torch import _build
    from controlanimate_tpu_torch.config import RunConfig
    from controlanimate_tpu_torch.models.annotators.depth import MODEL_ENV as DEPTH_MODEL_ENV
    from controlanimate_tpu_torch.models.annotators.glpn import GLPN_B0, GLPN_B4
    from controlanimate_tpu_torch.models.clip import CLIPTextConfig
    from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
    from controlanimate_tpu_torch.models.transformer import BasicTransformerBlock
    from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from controlanimate_tpu_torch.models.vae import VaeAttnBlock
    from controlanimate_tpu_torch.ops import attention as attention_module
    from controlanimate_tpu_torch.ops import conv_kernel as ck
    from controlanimate_tpu_torch.ops import flash_attention as fa
    from controlanimate_tpu_torch.ops import motion_kernel as mk
    from controlanimate_tpu_torch.ops import upconv_kernel as uk
    from controlanimate_tpu_torch.pipelines.engine import EngineModels
    from controlanimate_tpu_torch.pipelines.facade import MOTION_ENV, ControlAnimatePipeline
    from controlanimate_tpu_torch.weights.ingest import save_safetensors

    # the phases without K3 build their pipelines with the motion switch off
    os.environ[MOTION_ENV] = "0"

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    kind, count, smi = torch.cuda.get_device_name(0), torch.cuda.device_count(), nvidia_smi()
    phase("device", t0, kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    # torch.profiler's first use starts CUPTI, about 9 s on the card's
    # machine: it runs on a thread while nvcc builds. The SASS listing
    # (cuobjdump, seconds of host work) is read on the same thread during
    # the cfg phase, whose time the card takes; its checks follow that phase.
    side = ThreadPoolExecutor(max_workers=1)
    warm_job = side.submit(warm_profiler, torch)
    lib = _build.load_library()
    ptxas = ptxas_report(lib.log)
    phase("build", t0, nvcc_seconds=round(lib.build_seconds, 3), library=lib.path.name,
          profiler_start_seconds=round(warm_job.result(), 3), ptxas=ptxas)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    step_seconds = {}

    def step(name, fn):
        """fn() with its seconds (host clock, the card synchronised) kept
        under `name` in the reference phase's line."""
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        step_seconds[name] = round(time.perf_counter() - t1, 3)
        return out

    ref = step("small", lambda: small_reference(torch))
    ck.reset_launch_counts()
    ref_k2 = step("small_k2", lambda: small_reference(torch, conv_kernel=True))
    k2_ref_launches = ck.conv3x3_fused.launches
    mk.reset_launch_counts()
    ref_k3 = step("small_k3", lambda: small_reference(torch, motion_kernel=True))
    k3_ref_launches = mk.motion_module_fused.launches
    uk.reset_launch_counts()
    ref_up4 = step("upscale4", lambda: small_upscaler_reference(torch, 4.0))
    ref_up2 = step("upscale2", lambda: small_upscaler_reference(torch, 2.0))
    k4_ref_launches = uk.upconv3x3.launches
    ref_face = step("face", lambda: small_face_reference(torch))
    # at 512x768 only: the cfg and controlnet phases run canny at 512x512 on
    # the card
    ref_canny = step("canny", lambda: [
        canny_reference(torch, np, f(synthetic_video(np, 2, 768, 512, SEED)))
        for f in (lambda v: v, lambda v: edge_rich(np, v))])
    ref_hed = step("hed", lambda: small_hed_reference(torch))
    ref_annotators = step("annotators", lambda: small_annotator_reference(torch))
    ref_normalbae = step("normalbae", lambda: small_normalbae_reference(torch))
    ref_depth = step("depth", lambda: small_depth_reference(torch))
    ref_openpose = step("openpose", lambda: small_openpose_reference(torch))
    ref_cn = step("controlnet", lambda: small_controlnet_reference(torch))
    # a multi-step sampler: DPM-Solver under CFG 7.5 with a canny ControlNet
    # and K3, K1 and K3 on the doubled batch (B*F = 8, B = 2), and again at
    # guidance 1.0 (Euler under CFG and the LCM-LoRA tail run at full width
    # in the cfg and disk phases; their 64x64 card-against-CPU windows are in
    # tests/test_torch_gpu.py)
    fa.reset_launch_counts()
    mk.reset_launch_counts()
    ref_cfg_k3 = step("dpm_cfg_controlnet_k3", lambda: small_reference(
        torch, motion_kernel=True, controlnet=True, windows=1, unguided=True, **DPM_CFG))
    cfg_k1_batches = sorted({key[0] for key in fa.flash_attention.launches_by_shape})
    k3_cfg_batches = sorted({key[0] for key in mk.motion_module_fused.launches_by_shape})
    # the segment-parallel loop, 2 segments of one window (two in
    # tests/test_torch_gpu.py and against JAX in the CPU tests), card
    # against CPU and against the sequential loop on each segment
    ref_seg = step("segments", lambda: small_segment_reference(torch, windows=1))
    phase("reference", t0, **ref, k2_max_lsb=ref_k2["max_lsb"], k2_mean_lsb=ref_k2["mean_lsb"],
          k2_launches=k2_ref_launches, k3_max_lsb=ref_k3["max_lsb"],
          k3_mean_lsb=ref_k3["mean_lsb"], k3_launches=k3_ref_launches,
          upscale4_max_lsb=ref_up4["max_lsb"], upscale4_mean_lsb=ref_up4["mean_lsb"],
          upscale2_max_lsb=ref_up2["max_lsb"], upscale2_mean_lsb=ref_up2["mean_lsb"],
          k4_launches=k4_ref_launches, face=ref_face, canny=ref_canny, hed=ref_hed,
          annotators=ref_annotators, normalbae=ref_normalbae, depth=ref_depth,
          openpose=ref_openpose,
          controlnet=ref_cn,
          dpm_cfg_controlnet_k3=ref_cfg_k3, segments=ref_seg, cfg_k1_batches=cfg_k1_batches,
          cfg_k3_batches=k3_cfg_batches, step_seconds=step_seconds)
    for r in (ref, ref_k2, ref_k3, ref_cfg_k3):
        if r["max_lsb"] > 1:
            raise AssertionError(f"card and CPU pipelines differ by {r['max_lsb']} LSB")
    if ref_seg["max_lsb"] > 1 or ref_seg["sequential_max_lsb"] > 1:
        raise AssertionError(f"the card's segment run differs from the CPU's, or its first "
                             f"window from the sequential runs', by more than 1 LSB: {ref_seg}")
    if not ref_cfg_k3["guidance_change_max"]:
        raise AssertionError("guidance changed nothing: the small CFG window equals the "
                             "unguided one")
    # 4 frames doubled by CFG on K1 (and the VAE's 4); K3 at B = 2
    if 8 not in cfg_k1_batches or k3_cfg_batches != [2]:
        raise AssertionError(f"the CFG reference did not run K1 at B*F = 8 ({cfg_k1_batches}) "
                             f"or K3 at B = 2 ({k3_cfg_batches})")
    for r in (ref_up4, ref_up2):
        if r["max_lsb"] > 1:
            raise AssertionError(f"card and CPU upscalers differ by {r['max_lsb']} LSB")
    if k2_ref_launches == 0:
        raise AssertionError("the reference with use_pallas_conv launched no K2")
    if k3_ref_launches == 0:
        raise AssertionError(f"the reference with {MOTION_ENV}=1 launched no K3")
    if k4_ref_launches == 0:
        raise AssertionError("the reference upscalers launched no K4")
    if ref_hed["max_lsb"] > 1:
        raise AssertionError(f"HED on the card differs from the CPU by {ref_hed['max_lsb']} LSB")
    ra = ref_annotators
    if (ra["lineart_max_lsb"] > 1 or ra["mlsd_tp_err_over_rms"] > 1e-3 or ra["mlsd_draw_diff"]
            or not ra["mlsd_drawn_share"] or ra["resize_area_diff"] or ra["line_diff"]
            or ra["softedge_max_lsb"] > 1 or ra["lineart_anime_max_lsb"] > 1
            or min(sd for _, sd in ra["softedge_mean_std"] + ra["lineart_anime_mean_std"])
            <= 0.02):
        raise AssertionError(f"lineart, MLSD, softedge or lineart_anime on the card differs "
                             f"from the CPU, or a map is saturated: {ra}")
    if (ref_normalbae["max_lsb"] > 1
            or min(sd for _, sd in ref_normalbae["mean_std"]) <= 0.02):
        raise AssertionError(f"NormalBae on the card differs from the CPU, or its map is "
                             f"saturated: {ref_normalbae}")
    if any(r["err_over_largest"] > 1e-4 or r["std"] <= 0 for r in ref_depth.values()):
        raise AssertionError(f"a depth network on the card differs from the CPU by more than "
                             f"1e-4 of its largest value, or its map is constant: {ref_depth}")
    # the b0 GLPN's layers on K1 at head dim 32, fp32
    glpn_ref_k1 = glpn_k1_launches(GLPN_B0, 1, GLPN_REF_HW)
    if ref_depth["glpn"]["k1_launches"] != {str(k): n for k, n in sorted(glpn_ref_k1.items())}:
        raise AssertionError(f"the reference's GLPN launched K1 {ref_depth['glpn']}, expected "
                             f"{glpn_ref_k1}")
    rp = ref_openpose
    if (max(rp["net_err_over_rms"].values()) > 1e-3 or not rp["body_equal"]
            or rp["people"] != 2 or min(rp["hands_faces_drawn"]) < 1 or rp["canvas_diff"]
            or rp["ops_diff"]):
        raise AssertionError(f"OpenPose on the card differs from the CPU, or drew no person, "
                             f"hand or face: {rp}")
    if ref_cn["max_lsb"] > 1 or not ref_cn["controlnet_change_max"]:
        raise AssertionError(f"the card's ControlNet window differs from the CPU's, or the "
                             f"ControlNets changed nothing: {ref_cn}")
    if (ref_face["detector_rel_err"] > 1e-3 or ref_face["crop_max_lsb"]
            or ref_face["restore_max_lsb"] > 1 or ref_face["paste_max_lsb"] > 1):
        raise AssertionError(f"the card's face step differs from the CPU's: {ref_face}")

    # -- the main path ----------------------------------------------------
    t0 = time.perf_counter()
    size, frames_n, overlap, steps = 512, 16, 8, 4
    cfg = RunConfig(width=size, height=size, frame_count=frames_n, overlap_length=overlap,
                    use_lcm=True, steps=steps, guidance_scale=7.5, strength=0.9,
                    lcm_origin_steps=50, prompt="a cat, masterpiece", n_prompt="blurry",
                    dtype="bfloat16")
    tok = CLIPTokenizer.tiny()
    ccfg = CLIPTextConfig(vocab_size=len(tok.vocab), hidden_size=768, num_layers=12,
                          num_heads=12, intermediate_size=3072, eos_token_id=tok.eos_token_id)
    models, text = build_models(torch, UNet3DConfig(time_cond_proj_dim=256),
                                (128, 256, 512, 512), ccfg, "cuda", SEED)
    pipe = ControlAnimatePipeline(cfg, models=models, text_stack=text, device="cuda")
    n_params = sum(p.numel() for p in pipe.models.unet.parameters())
    torch.cuda.synchronize()
    phase("window_build", t0, unet_params=n_params)

    per_window = (
        sum(isinstance(m, BasicTransformerBlock) for m in pipe.models.unet.modules()) * steps
        + sum(isinstance(m, VaeAttnBlock) for m in pipe.models.vae.modules())
    )
    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(SEED)

    def new_frames(n):
        return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8, generator=fgen,
                             device="cuda")

    def check_window(out):
        if out.dtype != torch.uint8 or tuple(out.shape) != (frames_n, size, size, 3):
            raise AssertionError(f"window output {out.dtype} {tuple(out.shape)}")

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ck.reset_launch_counts()
    epoch = 0
    frames = new_frames(frames_n)
    out = pipe.animate(frames, None, overlaps=0, seed=SEED, epoch=epoch)  # warm-up
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check_window(out)

    # bench.py's count: whole windows without overlap, back to back
    t1 = time.perf_counter()
    for _ in range(WINDOWS):
        epoch += 1
        frames = new_frames(frames_n)
        out = pipe.animate(frames, None, overlaps=0, seed=SEED, epoch=epoch)
        check_window(out)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t1

    # the overlap-8 stream: each window keeps the last 8 frames of the one
    # before, reuses their cached latents and emits 8 new frames
    stream, cache_before = [], pipe._overlap_latent_cache
    t1 = time.perf_counter()
    for _ in range(WINDOWS):
        epoch += 1
        frames = torch.cat([frames[-overlap:], new_frames(frames_n - overlap)])
        stream.append((frames, out[-overlap:], epoch))
        out = pipe.animate(frames, out[-overlap:], overlaps=overlap, seed=SEED, epoch=epoch)
        check_window(out)
        if len(stream) == 1:
            first_overlap_out = out
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t1
    launches, by_shape = fa.flash_attention.launches, dict(fa.flash_attention.launches_by_shape)
    peak = torch.cuda.max_memory_allocated()

    if float(out.float().std()) == 0.0:
        raise AssertionError("window output is constant")
    n_windows = 1 + 2 * WINDOWS
    if launches != n_windows * per_window:
        raise AssertionError(f"K1 launched {launches} times, expected {n_windows * per_window}")
    expected = expected_k1_launches(1 + WINDOWS, WINDOWS, steps, frames_n, overlap)
    if by_shape != expected:
        raise AssertionError(f"K1 launches by shape {by_shape}, expected {expected}")
    if ck.conv3x3_fused.launches:
        raise AssertionError("K2 launched in the window phase, where use_pallas_conv is off")
    phase("window", t0, warmup_seconds=round(t_warm, 4), windows=WINDOWS,
          full_windows_seconds=round(t_full, 4),
          seconds_per_full_window=round(t_full / WINDOWS, 4),
          frames_per_second=round(frames_n * WINDOWS / t_full, 4),
          overlap_windows_seconds=round(t_stream, 4),
          seconds_per_overlap_window=round(t_stream / WINDOWS, 4),
          new_frames_per_second=round((frames_n - overlap) * WINDOWS / t_stream, 4),
          max_memory_allocated=peak, k1_launches=launches,
          k1_launches_per_window=per_window)

    t0 = time.perf_counter()
    pipe._overlap_latent_cache = cache_before
    frames, last, epoch = stream[0]
    with plain_attention(attention_module, fa.flash_attention_plain):
        t1 = time.perf_counter()
        out_plain = pipe.animate(frames, last, overlaps=overlap, seed=SEED, epoch=epoch)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t1
    diff = (first_overlap_out.int() - out_plain.int()).abs()
    phase("window_plain_attention", t0, overlap_window_seconds=round(t_plain, 4),
          new_frames_per_second=round((frames_n - overlap) / t_plain, 4),
          uint8_diff_mean=float(diff.float().mean()), uint8_diff_max=int(diff.max()))

    t0 = time.perf_counter()
    frames, last, epoch = stream[0]
    pipe._overlap_latent_cache = cache_before
    profile = profile_window(
        torch, lambda: pipe.animate(frames, last, overlaps=overlap, seed=SEED, epoch=epoch),
        t_stream / WINDOWS)
    phase("profile", t0, **profile)

    # -- K3's path: the overlap windows with the motion modules on K3
    t0 = time.perf_counter()
    with motion_env(True):
        pipe_k3 = ControlAnimatePipeline(cfg, models=models, text_stack=text, device="cuda")
    frames, last, epoch = stream[0]
    pipe_k3._overlap_latent_cache = cache_before
    pipe_k3.animate(frames, last, overlaps=overlap, seed=SEED, epoch=epoch)  # warm-up
    pipe_k3._overlap_latent_cache = cache_before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    t1 = time.perf_counter()
    for frames, last, epoch in stream:
        out_k3 = pipe_k3.animate(frames, last, overlaps=overlap, seed=SEED, epoch=epoch)
        check_window(out_k3)
    torch.cuda.synchronize()
    t_k3 = time.perf_counter() - t1
    k3_by_shape = dict(mk.motion_module_fused.launches_by_shape)
    k3_peak = torch.cuda.max_memory_allocated()
    models.unet.set_motion_kernel(False)
    del pipe_k3
    k3_expected = expected_k3_launches(models.unet, size // 8, frames_n, steps, WINDOWS)
    if k3_by_shape != k3_expected:
        raise AssertionError(f"K3 launches by shape {k3_by_shape}, expected {k3_expected}")
    if {k: n // (steps * WINDOWS) for k, n in k3_expected.items()} != K3_SHAPES:
        raise AssertionError(f"K3_SHAPES {K3_SHAPES} is not the UNet's {k3_expected}")
    if float(out_k3.float().std()) == 0.0:
        raise AssertionError("window output with K3 is constant")
    diff = (out.int() - out_k3.int()).abs()
    phase("window_motion_kernel", t0, overlap_windows_seconds=round(t_k3, 4),
          seconds_per_overlap_window=round(t_k3 / WINDOWS, 4),
          new_frames_per_second=round((frames_n - overlap) * WINDOWS / t_k3, 4),
          uint8_diff_mean=float(diff.float().mean()), uint8_diff_max=int(diff.max()),
          max_memory_allocated=k3_peak, k3_launches=sum(k3_by_shape.values()),
          k3_launches_per_window=sum(k3_by_shape.values()) // WINDOWS,
          k3_launches_by_shape={str(k): n for k, n in sorted(k3_by_shape.items())})
    del diff, out_k3

    # -- the main path: the vid2vid loop with K2 on ------------------------
    from controlanimate_tpu_torch import vid2vid as v2v
    from controlanimate_tpu_torch.io.media import ArrayFrameSink, ArrayFrameSource
    from controlanimate_tpu_torch.ops.blending import blend_overlap_u8
    from controlanimate_tpu_torch.ops.color_match import match_colors_u8

    video = synthetic_video(np, frames_n + V2V_OVERLAP_WINDOWS * (frames_n - overlap), size,
                            size, SEED)

    class Recording:
        """The facade, keeping the first two windows' raw frames."""

        def __init__(self, pipe):
            self.pipe, self.device, self.raw = pipe, pipe.device, []

        def animate(self, *args, **kw):
            out = self.pipe.animate(*args, **kw)
            if len(self.raw) < 2:
                self.raw.append(out.clone())
            return out

        def prepare_cond_images(self, *args, **kw):
            return self.pipe.prepare_cond_images(*args, **kw)

    def run_vid2vid(conv_kernel: bool, tag: str, upscaler=None, engine_models=None,
                    text_stack=None, source=None, max_windows=None, ip_adapter=None,
                    **settings):
        vcfg = cfg.replace(**{
            "use_pallas_conv": conv_kernel, "seed": SEED, "overlap_strength": cfg.strength,
            "upscale": 1.0 if upscaler is None else upscaler.scale,
            "output_video_dir": str(ROOT / "build" / "chip_smoke_vid2vid" / tag), **settings})
        rec = Recording(ControlAnimatePipeline(vcfg, models=engine_models or models,
                                               text_stack=text_stack or text,
                                               ip_adapter=ip_adapter, device="cuda"))
        sink = ArrayFrameSink()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for module in (fa, ck, mk, uk):
            module.reset_launch_counts()
        t1 = time.perf_counter()
        summary = v2v.vid2vid(config=vcfg, pipeline=rec,
                              frame_source=ArrayFrameSource(video if source is None else source),
                              frame_sink=sink, upscaler=upscaler, max_windows=max_windows)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        counts = {"k1": fa.flash_attention.launches,
                  "k1_by_shape": dict(fa.flash_attention.launches_by_shape),
                  "k2": ck.conv3x3_fused.launches,
                  "k2_by_shape": dict(ck.conv3x3_fused.launches_by_shape),
                  "k3": mk.motion_module_fused.launches,
                  "k4": uk.upconv3x3.launches,
                  "k4_by_shape": dict(uk.upconv3x3.launches_by_shape)}
        return summary, sink.frames, seconds, rec.raw, counts, torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    v2v_windows = 1 + V2V_OVERLAP_WINDOWS
    summary, v2v_frames, v2v_seconds, raw, counts, v2v_peak = run_vid2vid(True, "k2")
    if summary["frames_written"] != len(video) or len(v2v_frames) != len(video):
        raise AssertionError(f"vid2vid wrote {summary['frames_written']} frames "
                             f"({len(v2v_frames)} in the sink) of {len(video)}")
    if summary["windows"] != v2v_windows:
        raise AssertionError(f"vid2vid ran {summary['windows']} windows, expected {v2v_windows}")
    if any(f.shape != (size, size, 3) or f.dtype != np.uint8 for f in v2v_frames):
        raise AssertionError("vid2vid frames are not (512, 512, 3) uint8")
    # window 2's emitted head is window 1's tail blended with window 2's frames
    # color-matched to window 1's anchor (its frame overlap - 1)
    matched = match_colors_u8(raw[1], raw[0][overlap - 1])
    color_change = float((matched.int() - raw[1].int()).abs().float().mean())
    expect = blend_overlap_u8(matched[:overlap], raw[0][-overlap:]).cpu().numpy()
    got = np.stack(v2v_frames[frames_n - overlap:frames_n])
    if color_change == 0.0 or not np.array_equal(got, expect):
        raise AssertionError(f"the stitch did not run as expected on window 2 "
                             f"(color match change {color_change}, "
                             f"max diff {np.abs(got.astype(int) - expect).max()})")
    k1_expected = expected_k1_launches(1, V2V_OVERLAP_WINDOWS, steps, frames_n, overlap)
    if counts["k1_by_shape"] != k1_expected:
        raise AssertionError(f"vid2vid K1 launches {counts['k1_by_shape']}, "
                             f"expected {k1_expected}")
    k2_expected = expected_k2_launches(models.vae, (size, size), frames_n, overlap, 1,
                                       V2V_OVERLAP_WINDOWS)
    if counts["k2_by_shape"] != k2_expected:
        raise AssertionError(f"vid2vid K2 launches {counts['k2_by_shape']}, "
                             f"expected {k2_expected}")
    phase("vid2vid", t0, windows=summary["windows"], frames_written=summary["frames_written"],
          loop_seconds=round(v2v_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary["frames_written"] / v2v_seconds, 4),
          color_match_mean_change_window2=color_change, max_memory_allocated=v2v_peak,
          k1_launches=counts["k1"], k2_launches=counts["k2"],
          k2_launches_per_full_window=sum(
              expected_k2_launches(models.vae, (size, size), frames_n, overlap, 1, 0).values()),
          k2_launches_per_overlap_window=sum(
              expected_k2_launches(models.vae, (size, size), frames_n, overlap, 0, 1).values()),
          timers=summary["timers"])
    v2v_counts = counts

    t0 = time.perf_counter()
    summary_plain, plain_frames, plain_seconds, _, counts, plain_peak = run_vid2vid(False,
                                                                                     "plain")
    if counts["k2"] or counts["k4"] or summary_plain["frames_written"] != len(video):
        raise AssertionError("the plain-conv vid2vid rerun launched K2 or K4 or lost frames")
    diff = np.abs(np.stack(plain_frames).astype(np.int16) - np.stack(v2v_frames).astype(np.int16))
    phase("vid2vid_plain_conv", t0, loop_seconds=round(plain_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary_plain["frames_written"] / plain_seconds, 4),
          uint8_diff_mean=float(diff.mean()), uint8_diff_max=int(diff.max()),
          max_memory_allocated=plain_peak, timers=summary_plain["timers"])
    print(json.dumps({"peak_memory": {"vid2vid": v2v_peak, "vid2vid_plain_conv": plain_peak,
                                      "difference": v2v_peak - plain_peak}}), flush=True)
    del diff, raw, matched

    # -- the UNet's attention variants: sparse-causal self-attention and the
    # temporal sub-layer on K1, the motion modules banded with K3 off ------
    t0 = time.perf_counter()
    vgen = torch.Generator(device="cuda")
    vgen.manual_seed(SEED + 2)
    var_unet = variant_unet(torch, models.unet, VARIANT_BAND, vgen)
    var_models = EngineModels(unet=var_unet, vae=models.vae)
    torch.cuda.synchronize()
    t_var_build = time.perf_counter() - t0
    var_n = 2 * frames_n - overlap  # one whole and one overlap window
    with motion_env(True):
        summary_var, var_frames, var_seconds, _, counts, var_peak = run_vid2vid(
            False, "variants", engine_models=var_models, source=video[:var_n],
            temporal_band=VARIANT_BAND)
    var_k1 = counts["k1_by_shape"]
    var_k1_expected = variant_k1_launches(1, 1, steps, frames_n, overlap)
    if summary_var["frames_written"] != var_n or len(var_frames) != var_n:
        raise AssertionError(f"the variant loop wrote {summary_var['frames_written']} frames")
    if any(f.shape != (size, size, 3) or f.dtype != np.uint8 for f in var_frames):
        raise AssertionError("the variant loop's frames are not (512, 512, 3) uint8")
    var_change = np.abs(np.stack(var_frames).astype(np.int16)
                        - np.stack(plain_frames[:var_n]).astype(np.int16))
    if float(np.stack(var_frames).std()) == 0.0 or not var_change.max():
        raise AssertionError("the variant loop's frames are constant or equal "
                             "vid2vid_plain_conv's")
    if var_k1 != var_k1_expected:
        raise AssertionError(f"the variant loop launched K1 {var_k1}, expected {var_k1_expected}")
    if counts["k3"] or counts["k2"] or counts["k4"]:
        raise AssertionError(f"the variant loop (band {VARIANT_BAND} at {frames_n} frames: "
                             f"active) launched K3 {counts['k3']} times, or K2 or K4")
    # a band of F - 1 covers every frame pair: exact dense attention, on K3
    set_motion_band(var_unet, frames_n - 1)
    with motion_env(True):
        pipe15 = ControlAnimatePipeline(cfg.replace(temporal_band=frames_n - 1),
                                        models=var_models, text_stack=text, device="cuda")
    frames15 = torch.from_numpy(video[:frames_n]).cuda()
    pipe15.animate(frames15, None, overlaps=0, seed=SEED, epoch=0)  # warm-up
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    t1 = time.perf_counter()
    out15 = pipe15.animate(frames15, None, overlaps=0, seed=SEED, epoch=0)
    torch.cuda.synchronize()
    t15 = time.perf_counter() - t1
    check_window(out15)
    k3_15 = dict(mk.motion_module_fused.launches_by_shape)
    k3_15_expected = expected_k3_launches(var_unet, size // 8, frames_n, steps, 1)
    if k3_15 != k3_15_expected or sum(k3_15.values()) != sum(K3_SHAPES.values()) * steps:
        raise AssertionError(f"at band {frames_n - 1} K3 launched {k3_15}, expected "
                             f"{k3_15_expected}")
    phase("window_variants", t0, band=VARIANT_BAND, build_seconds=round(t_var_build, 4),
          sub_layer_params=sum(p.numel() for n, p in var_unet.named_parameters()
                               if "_temp." in n),
          windows=summary_var["windows"], frames_written=summary_var["frames_written"],
          loop_seconds=round(var_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary_var["frames_written"] / var_seconds, 4),
          seconds_per_window=round(var_seconds / summary_var["windows"], 4),
          plain_conv_seconds_per_window=round(plain_seconds / summary_plain["windows"], 4),
          uint8_diff_from_plain_mean=float(var_change.mean()),
          uint8_diff_from_plain_max=int(var_change.max()), max_memory_allocated=var_peak,
          k1_launches=sum(var_k1.values()), k3_launches=counts["k3"],
          k1_launches_by_shape={str(k): n for k, n in sorted(var_k1.items())},
          band_dense={"band": frames_n - 1, "window_seconds": round(t15, 4),
                      "k3_launches": sum(k3_15.values())},
          timers=summary_var["timers"])
    del var_unet, var_models, pipe15, frames15, out15, var_frames, var_change
    torch.cuda.empty_cache()

    # -- this slice's path: the loop with two ControlNets -------------------
    from controlanimate_tpu_torch.models.annotators.edge_nets import ControlNetHED, HEDAnnotator
    from controlanimate_tpu_torch.ops.canny import canny

    t0 = time.perf_counter()
    cgen = torch.Generator(device="cuda")
    cgen.manual_seed(SEED + 1)
    cn_nets = seeded_controlnets(torch, models.unet.config, len(CN_NAMES), "cuda", cgen)
    with torch.device("cuda"):
        hed_net = ControlNetHED()
    init_hed_(torch, hed_net, cgen)
    hed = HEDAnnotator(hed_net)
    cn_settings = {"controlnets": CN_NAMES, "cond_scale": CN_SCALES}
    cn_models = EngineModels(unet=models.unet, vae=models.vae, controlnets=cn_nets,
                             annotators=[canny, hed])
    torch.cuda.synchronize()
    t_cn_build = time.perf_counter() - t0
    # one whole and one overlap window
    cn_n = 2 * frames_n - overlap
    summary_cn, cn_frames, cn_seconds, _, counts, cn_peak = run_vid2vid(
        False, "controlnet", engine_models=cn_models, source=video[:cn_n], **cn_settings)
    if summary_cn["frames_written"] != cn_n or len(cn_frames) != cn_n:
        raise AssertionError(f"the ControlNet loop wrote {summary_cn['frames_written']} frames")
    if any(f.shape != (size, size, 3) or f.dtype != np.uint8 for f in cn_frames):
        raise AssertionError("the ControlNet loop's frames are not (512, 512, 3) uint8")
    cn_change = np.abs(np.stack(cn_frames).astype(np.int16)
                       - np.stack(plain_frames[:cn_n]).astype(np.int16))
    if not cn_change.max():
        raise AssertionError("the ControlNets left vid2vid_plain_conv's frames unchanged")
    if counts["k2"] or counts["k4"]:
        raise AssertionError("the ControlNet loop launched K2 or K4")
    cn_k1 = counts["k1_by_shape"]
    cn_k1_expected = expected_k1_launches(1, 1, steps, frames_n, overlap,
                                          controlnets=len(CN_NAMES))
    cn_blocks = sum(isinstance(m, BasicTransformerBlock) for m in cn_nets[0].modules())
    if cn_k1 != cn_k1_expected or cn_blocks != sum(n for *_, n in CONTROLNET_LEVELS):
        raise AssertionError(f"ControlNet loop K1 launches {cn_k1}, expected {cn_k1_expected} "
                             f"({cn_blocks} transformer blocks a ControlNet)")
    # a window's parts alone, by CUDA events: each annotator on 16 frames,
    # each ControlNet's
    # forwards of a window (`steps` of them, bf16), these also on the card
    # alone (torch.profiler's summed activity, without waits for the host)
    window_frames = torch.from_numpy(video[:frames_n]).cuda()
    canny_ms = cuda_ms(torch, lambda: canny(window_frames), 3)
    hed_ms = cuda_ms(torch, lambda: hed(window_frames), 2)
    ctx = text.encode(cfg.prompt)
    lat = torch.randn((1, frames_n, size // 8, size // 8, 4), generator=cgen, device="cuda",
                      dtype=torch.bfloat16)
    cond = [(a(window_frames) * 255.0 + 0.5).to(torch.uint8)[None].float() / 255.0
            for a in (canny, hed)]
    t_step = torch.tensor(500, device="cuda")

    def net_window(net, c, scale):
        with torch.no_grad():
            for _ in range(steps):
                net(lat, t_step, ctx, c, conditioning_scale=scale)

    cn_ms = [cuda_ms(torch, lambda: net_window(net, c, sc), 2)
             for net, c, sc in zip(cn_nets, cond, CN_SCALES)]
    # on the card alone for the first net only (the two share an architecture)
    cn_device_ms = [device_busy_ms(torch, lambda: net_window(cn_nets[0], cond[0], CN_SCALES[0]),
                                   2)]
    # the disk phase's LCM-LoRA annotators (openpose, lineart, MLSD; seeded
    # on the card, MLSD's head set on this window) beside canny and HED, each
    # on one 16-frame window at the shipped 512x768, by CUDA events
    from controlanimate_tpu_torch.models.annotators.depth import DepthAnnotator, depth_network
    from controlanimate_tpu_torch.models.annotators.dpt import DPT_LARGE
    from controlanimate_tpu_torch.models.annotators.dpt_hybrid import DPT_HYBRID_MIDAS
    from controlanimate_tpu_torch.models.annotators.edge_nets import (LineartAnnotator,
                                                                     LineartGenerator)
    from controlanimate_tpu_torch.models.annotators.lineart_anime import (LineartAnimeAnnotator,
                                                                          UnetGenerator)
    from controlanimate_tpu_torch.models.annotators.mlsd import MLSDAnnotator
    from controlanimate_tpu_torch.models.annotators.normalbae import NormalBaeAnnotator
    from controlanimate_tpu_torch.models.annotators.openpose import body_input_size
    from controlanimate_tpu_torch.models.annotators.pidinet import PidiNetAnnotator
    from controlanimate_tpu_torch.models.annotators.seeded import (
        dpt_checkpoint, dpt_hybrid_checkpoint, glpn_checkpoint, mlsd_checkpoint, mlsd_model,
        normalbae_checkpoint, normalbae_model, openpose_checkpoints, pidinet_checkpoint,
        pidinet_model, pose_maps, seed_lineart_, seed_lineart_anime_, write_depth_folder)

    video_768 = synthetic_video(np, 2 * frames_n - overlap, 768, size, SEED)
    frames_768 = torch.from_numpy(video_768[:frames_n]).cuda()
    with torch.device("cuda"):
        lineart_net = LineartGenerator()
    lineart = LineartAnnotator(seed_lineart_(lineart_net, cgen))
    mlsd_sd = mlsd_checkpoint(cgen, window_frames)
    mlsd_ann = MLSDAnnotator(mlsd_model(mlsd_sd, "cuda"))
    pose_sds = openpose_checkpoints(cgen)
    openpose_ann = openpose_annotator(torch, pose_sds, "cuda")
    # the disk phase's softedge and lineart_anime (PidiNet's classifier set
    # on this window), from a generator of their own
    agen = torch.Generator(device="cuda")
    agen.manual_seed(SEED + 10)
    pidi_ckpt = pidinet_checkpoint(agen, window_frames)
    softedge = PidiNetAnnotator(pidinet_model(pidi_ckpt, "cuda"))
    with torch.device("cuda"):
        anime_net = UnetGenerator()
    lineart_anime = LineartAnimeAnnotator(seed_lineart_anime_(anime_net, agen))
    # and normalbae, its statistics from this window at 512x512 (the disk
    # phase's size), the file kept in the released nesting for the disk phase
    nb_ckpt = normalbae_checkpoint(agen, window_frames)
    nb_ckpt = {"model": {k: v.cpu() for k, v in nb_ckpt["model"].items()}}
    normalbae = NormalBaeAnnotator(normalbae_model(nb_ckpt, "cuda"))
    # and the two full-depth depth networks (Intel/dpt-large and
    # dpt-hybrid-midas geometry), their heads calibrated on this window
    dpt_config, dpt_sd = dpt_checkpoint(agen, window_frames)
    depth_dpt = DepthAnnotator(depth_network(dpt_config, dpt_sd, "cuda"))
    hybrid_config, hybrid_sd = dpt_hybrid_checkpoint(agen, window_frames)
    depth_hybrid = DepthAnnotator(depth_network(hybrid_config, hybrid_sd, "cuda"))
    del dpt_sd, hybrid_sd
    # and GLPN at the published b4 widths (vinvino02/glpn-nyu), its head
    # calibrated on this window at 512x512, the size the disk phase's CLI
    # run reads it at from models/annotators/glpn/
    glpn_config, glpn_sd = glpn_checkpoint(agen, window_frames, GLPN_B4)
    glpn_sd = {k: v.cpu() for k, v in glpn_sd.items()}
    depth_glpn = DepthAnnotator(depth_network(glpn_config, glpn_sd, "cuda"))
    annotators_768 = {"canny": canny, "hed": hed, "lineart": lineart, "mlsd": mlsd_ann,
                      "openpose": openpose_ann, "softedge": softedge,
                      "lineart_anime": lineart_anime, "normalbae": normalbae,
                      "depth_dpt": depth_dpt, "depth_hybrid": depth_hybrid,
                      "depth_glpn": depth_glpn}
    # the first call warms each annotator up; the second, timed, must agree;
    # its peak memory above what was allocated before it
    maps_768 = {name: a(frames_768) for name, a in annotators_768.items()}
    repeatable, annotator_ms, annotator_peak = {}, {}, {}
    fa.reset_launch_counts()
    for name, a in annotators_768.items():
        again = []
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        annotator_ms[name] = cuda_ms(torch, lambda a=a: again.append(a(frames_768)), 1,
                                     warmup=0)
        annotator_peak[name] = torch.cuda.max_memory_allocated() - resident
        repeatable[name] = torch.equal(again[0], maps_768[name])
        del again
    # K1's launches in those second calls: the depth networks' ViTs and
    # GLPN's 41 layers (fp32)
    depth_k1 = dict(fa.flash_attention.launches_by_shape)
    glpn_768_k1 = glpn_k1_launches(GLPN_B4, frames_n, (768, size))
    depth_k1_expected = {(frames_n, 577, 577, 16, 64): DPT_LARGE.num_layers,
                         (frames_n, 577, 577, 12, 64): DPT_HYBRID_MIDAS.num_layers,
                         **glpn_768_k1}
    seeded_stats = dict(openpose_ann.stats)
    # a seeded body network finds no one: openpose's decode, crops and
    # drawing timed again on crafted maps of two people in every frame
    h8, w8 = body_input_size(768, size)
    heat8, paf8 = (torch.from_numpy(m).cuda()[None].expand(frames_n, -1, -1, -1).contiguous()
                   for m in pose_maps(768, size, h8 // 8, w8 // 8))
    # warm-up and the repeat check on 2 frames, then one timed 16-frame call
    two = (frames_768[:2], paf8[:2], heat8[:2])
    pose_repeatable = torch.equal(openpose_ann.draw(*two), openpose_ann.draw(*two))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    pose_map = openpose_ann.draw(frames_768, paf8, heat8)
    events[1].record()
    torch.cuda.synchronize()
    pose_ms = events[0].elapsed_time(events[1])
    pose_stats = dict(openpose_ann.stats)
    body_ms = cuda_ms(torch, lambda: openpose_ann.body_maps(frames_768), 1, warmup=0)
    print(json.dumps({"annotators_512x768": {
        "frames": frames_n, "ms_per_window": annotator_ms, "repeatable": repeatable,
        "peak_memory_over_resident": annotator_peak,
        "lineart_params": sum(p.numel() for p in lineart_net.parameters()),
        "softedge_params": sum(p.numel() for p in softedge.model.parameters()),
        "lineart_anime_params": sum(p.numel() for p in anime_net.parameters()),
        "normalbae_params": sum(p.numel() for p in normalbae.model.parameters()),
        "depth_params": {"dpt": sum(p.numel() for p in depth_dpt.model.parameters()),
                         "hybrid": sum(p.numel() for p in depth_hybrid.model.parameters()),
                         "glpn": sum(p.numel() for p in depth_glpn.model.parameters())},
        "depth_k1_launches": {str(k): n for k, n in sorted(depth_k1.items())},
        "map_channel_std": {k: [float(v) for v in m.reshape(-1, 3).std(0)]
                            for k, m in maps_768.items()},
        "mlsd_params": sum(p.numel() for p in mlsd_ann.model.parameters()),
        "openpose_params": {n: sum(p.numel() for p in m.parameters()) for n, m in (
            ("body", openpose_ann.body), ("hand", openpose_ann.hand),
            ("face", openpose_ann.face))},
        "openpose_seeded": seeded_stats, "openpose_body_network_ms": body_ms,
        "openpose_two_people": {"draw_ms": pose_ms, "repeatable": pose_repeatable,
                                "drawn_share": float((pose_map > 0).any(-1).float().mean()),
                                **pose_stats},
        "map_mean": {k: float(m.mean()) for k, m in maps_768.items()},
        "map_std": {k: float(m.std()) for k, m in maps_768.items()}}}), flush=True)
    # the seeded openpose map is black; the others must not be constant, and
    # the depth maps' std must pass 0.05
    if (not all(float(m.std()) > 0 for k, m in maps_768.items() if k != "openpose")
            or not all(float(maps_768[k].std()) > 0.05
                       for k in ("depth_dpt", "depth_hybrid", "depth_glpn"))
            or not all(repeatable.values()) or not pose_repeatable):
        raise AssertionError(f"an annotator's 512x768 maps are constant, a depth map's std is "
                             f"0.05 or less, or a map differs from one call to the next: "
                             f"{repeatable}, {pose_repeatable}")
    if depth_k1 != depth_k1_expected:
        raise AssertionError(f"the depth networks launched K1 {depth_k1}, expected "
                             f"{depth_k1_expected}")
    if (pose_stats["people"] != 2 * frames_n or pose_stats["hands"] < frames_n
            or pose_stats["faces"] < frames_n):
        raise AssertionError(f"openpose drew {pose_stats} on the crafted maps of two people "
                             f"in {frames_n} frames")
    del window_frames, cond, lat, frames_768, maps_768, heat8, paf8, pose_map
    # the DPTs go (the plain one's 1.37 GB); the disk phase keeps GLPN
    del annotators_768, depth_dpt, depth_hybrid
    phase("controlnet", t0, build_seconds=round(t_cn_build, 4), nets=list(CN_NAMES),
          cond_scale=list(CN_SCALES),
          controlnet_params=sum(p.numel() for p in cn_nets[0].parameters()),
          hed_params=sum(p.numel() for p in hed_net.parameters()),
          windows=summary_cn["windows"],
          frames_written=summary_cn["frames_written"], loop_seconds=round(cn_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary_cn["frames_written"] / cn_seconds, 4),
          vid2vid_plain_conv_new_frames_per_second=round(
              summary_plain["frames_written"] / plain_seconds, 4),
          uint8_change_vs_plain_conv_mean=float(cn_change.mean()),
          uint8_change_vs_plain_conv_max=int(cn_change.max()),
          controlnet_ms_per_window=cn_ms, controlnet_device_ms_per_window=cn_device_ms,
          canny_ms_per_window=canny_ms,
          hed_ms_per_window=hed_ms,
          max_memory_allocated=cn_peak, k1_launches=sum(cn_k1.values()),
          k1_launches_by_shape={str(k): n for k, n in sorted(cn_k1.items())},
          timers=summary_cn["timers"])
    del cn_change
    torch.cuda.empty_cache()

    # -- this slice's path: the default profile's sampler under CFG ---------
    from controlanimate_tpu_torch.schedulers import make_schedule, make_scheduler

    t0 = time.perf_counter()
    sass_job = side.submit(sass_counts, lib.path, Path(_build._nvcc()).with_name("cuobjdump"),
                           ("HMMA", "LDGSTS", "LDSM"))
    # the SD1.5 UNet without the LCM w-embedding (no cond_proj), sharing the
    # window phase's weights
    with torch.device("meta"):
        unet_sd15 = UNet3DConditionModel(UNet3DConfig())
    lcm_state = models.unet.state_dict()
    unet_sd15.load_state_dict({k: lcm_state[k] for k in unet_sd15.state_dict()}, assign=True)
    del lcm_state
    cfg_models = EngineModels(unet=unet_sd15, vae=models.vae, controlnets=cn_nets[:1],
                              annotators=[canny])
    cfg_settings = {**CFG_PROFILE, "controlnets": CN_NAMES[:1], "cond_scale": CN_SCALES[:1]}
    cfg_video = video[:frames_n]  # one whole window
    summary_cfg, cfg_frames, cfg_seconds, _, counts, cfg_peak = run_vid2vid(
        True, "cfg", engine_models=cfg_models, source=cfg_video, **cfg_settings)
    if summary_cfg["frames_written"] != len(cfg_video) or len(cfg_frames) != len(cfg_video):
        raise AssertionError(f"the CFG loop wrote {summary_cfg['frames_written']} frames")
    if any(f.shape != (size, size, 3) or f.dtype != np.uint8 for f in cfg_frames):
        raise AssertionError("the CFG loop's frames are not (512, 512, 3) uint8")
    if float(np.stack(cfg_frames).std()) == 0.0:
        raise AssertionError("the CFG loop's frames are constant")
    # the window's steps as the port's sampler builds them: 10
    cfg_window_steps = [make_scheduler(CFG_PROFILE["scheduler"], make_schedule(),
                                       CFG_PROFILE["steps"],
                                       strength=CFG_PROFILE["strength"]).num_steps]
    cfg_k1 = counts["k1_by_shape"]
    cfg_k1_expected = expected_cfg_k1_launches(cfg_window_steps, frames_n, [], controlnets=1)
    per_step = sum(isinstance(m, BasicTransformerBlock)
                   for net in (unet_sd15, cn_nets[0]) for m in net.modules())
    # and the VAE's mid attention in the decode
    if (cfg_k1 != cfg_k1_expected
            or sum(cfg_k1.values()) != per_step * sum(cfg_window_steps) + 1):
        raise AssertionError(f"CFG loop K1 launches {cfg_k1}, expected {cfg_k1_expected} "
                             f"({per_step} self-attentions a step)")
    cfg_k2 = counts["k2_by_shape"]
    cfg_k2_expected = vae_k2_launches(models.vae, (size, size), [frames_n], [])
    if cfg_k2 != cfg_k2_expected or counts["k4"]:
        raise AssertionError(f"CFG loop K2 launches {cfg_k2}, expected {cfg_k2_expected}, "
                             f"or K4 launched")
    # guidance at full width: the first window's first Euler step through the
    # engine, from the same latents and condition map, under CFG 7.5 and at
    # 1.0 (the positive prompt alone); the two steps must differ
    from controlanimate_tpu_torch.pipelines.engine import TorchNoise

    cfg_pipe = ControlAnimatePipeline(cfg.replace(**cfg_settings), models=cfg_models,
                                      text_stack=text, device="cuda")
    pos, neg = cfg_pipe._encode_prompts(cfg.prompt, cfg.n_prompt)
    st_cfg = cfg_pipe.window_static()
    first_step = cfg_pipe.engine.build_scheduler(st_cfg)
    first_step.num_steps = 1  # the window's first step alone
    step_noise = TorchNoise(SEED, "cuda")
    lat0 = step_noise.initial((1, frames_n, size // 8, size // 8, 4)) * first_step.init_noise_sigma
    step_cond = cfg_pipe.prepare_cond_images(cfg_video[:frames_n])
    t1 = time.perf_counter()
    with torch.no_grad():
        guided = cfg_pipe.engine.denoise(st_cfg, first_step, torch.cat([neg, pos]), lat0,
                                         step_noise, step_cond)
        unguided = cfg_pipe.engine.denoise(dataclasses.replace(st_cfg, guidance_scale=1.0),
                                           first_step, pos, lat0, step_noise, step_cond)
    guidance_change = float((guided - unguided).abs().max())
    guidance_seconds = time.perf_counter() - t1
    if not guidance_change > 0.0:
        raise AssertionError("guidance changed nothing: the CFG step equals the unguided one")
    del lat0, step_cond, guided, unguided, cfg_pipe
    # a step's parts alone, by CUDA events: the UNet and the ControlNet on
    # the doubled batch
    ctx2 = torch.cat([neg, pos])
    lat2 = torch.randn((2, frames_n, size // 8, size // 8, 4), generator=cgen, device="cuda",
                       dtype=torch.bfloat16)
    cond2 = (canny(torch.from_numpy(cfg_video[:frames_n]).cuda())[None].float()).expand(
        2, -1, -1, -1, -1)
    with torch.no_grad():
        unet_step_ms = cuda_ms(torch, lambda: unet_sd15(lat2, t_step, ctx2), 2)
        cn_step_ms = cuda_ms(torch, lambda: cn_nets[0](lat2, t_step, ctx2, cond2), 2)
    del lat2, cond2, ctx2
    phase("cfg", t0, settings=cfg_settings, window_steps=cfg_window_steps,
          windows=summary_cfg["windows"], frames_written=summary_cfg["frames_written"],
          loop_seconds=round(cfg_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary_cfg["frames_written"] / cfg_seconds, 4),
          unet_step_ms_doubled=unet_step_ms, controlnet_step_ms_doubled=cn_step_ms,
          first_step_change_vs_unguided_max=guidance_change,
          first_step_pair_seconds=round(guidance_seconds, 4),
          max_memory_allocated=cfg_peak, k1_launches=sum(cfg_k1.values()),
          k1_launches_by_shape={str(k): n for k, n in sorted(cfg_k1.items())},
          k2_launches=sum(cfg_k2.values()), timers=summary_cfg["timers"])
    del cfg_frames, cfg_models, unet_sd15
    torch.cuda.empty_cache()

    sass = sass_job.result()
    side.shutdown()
    k1_hmma = {name: n for name, n in sass["HMMA"].items() if "attn_" in name}
    print(json.dumps({"k1_ptxas": [r for r in ptxas if "attn_" in r["function"]],
                      "k1_hmma": k1_hmma,
                      "k1_bf16_dynamic_smem": {D: lib.lib.flash_attention_bf16_smem_bytes(D)
                                               for D in fa.SUPPORTED_HEAD_DIMS}}), flush=True)
    bf16_k1 = [name for name in k1_hmma if "attn_bf16" in name]
    if not bf16_k1 or not all(k1_hmma[name] for name in bf16_k1):
        raise AssertionError(f"bf16 K1 kernels without tensor-core instructions: {k1_hmma}")
    k1_spills = [r for r in ptxas if "attn_bf16" in r["function"]
                 and (r.get("spill_stores") or r.get("spill_loads"))]
    if k1_spills or len(bf16_k1) != len(fa.SUPPORTED_HEAD_DIMS):
        raise AssertionError(f"bf16 K1 kernels spill registers, or not one a head dim: "
                             f"{k1_spills}, {bf16_k1}")
    k2_ptxas = [r for r in ptxas if "conv3x3" in r["function"]]
    k2_sass = {op: {name: n for name, n in sass[op].items() if "conv3x3" in name}
               for op in ("HMMA", "LDGSTS")}
    print(json.dumps({"k2_ptxas": k2_ptxas, "k2_hmma": k2_sass["HMMA"],
                      "k2_ldgsts": k2_sass["LDGSTS"]}), flush=True)
    bf16_k2 = [name for name in k2_sass["HMMA"] if "conv3x3_bf16" in name]
    if not bf16_k2 or not all(k2_sass["HMMA"][n] and k2_sass["LDGSTS"][n] for n in bf16_k2):
        raise AssertionError(f"bf16 K2 kernels without tensor-core (HMMA) or cp.async (LDGSTS) "
                             f"instructions: {k2_sass}")
    spilled = [r for r in k2_ptxas if "conv3x3_bf16" in r["function"]
               and (r.get("spill_stores") or r.get("spill_loads"))]
    if spilled:
        raise AssertionError(f"bf16 K2 kernels spill registers: {spilled}")
    pipelined_build_report("k3", "motion", "motion_gemm_bf16", ptxas, sass)
    pipelined_build_report("k4", "upconv", "upconv_bf16", ptxas, sass)

    # -- K4's path: the loop with the x4 upscaler, its tail on K4 ----------
    from controlanimate_tpu_torch.models.upscaler import RRDBNet, Upscaler

    t0 = time.perf_counter()
    ugen = torch.Generator(device="cuda")
    ugen.manual_seed(SEED)
    with torch.device("cuda"):
        rrdb = RRDBNet()  # RealESRGAN_x4plus_anime_6B: 64 features, 6 blocks
    init_rrdbnet_(torch, rrdb, ugen, RRDB_LAST_GAIN)
    upscaler = Upscaler(4.0, model=rrdb, dtype=torch.bfloat16, device="cuda")
    # warm-up: cuDNN picks its algorithms for the body outside the timed loop
    upscaler.upscale_batch_device(torch.from_numpy(video[:1]).cuda())
    torch.cuda.synchronize()
    t_up_build = time.perf_counter() - t0
    # one whole and one overlap window
    up_n = 2 * frames_n - overlap
    summary_up, up_frames, up_seconds, _, counts, up_peak = run_vid2vid(
        False, "upscale", upscaler, source=video[:up_n])
    up_size = 4 * size
    if summary_up["frames_written"] != up_n or len(up_frames) != up_n:
        raise AssertionError(f"vid2vid with upscale wrote {summary_up['frames_written']} frames "
                             f"({len(up_frames)} in the sink) of {up_n}")
    if any(f.shape != (up_size, up_size, 3) or f.dtype != np.uint8 for f in up_frames):
        raise AssertionError(f"upscaled frames are not ({up_size}, {up_size}, 3) uint8")
    emits = [frames_n - overlap] * 2 + [overlap]
    k4_expected = expected_k4_launches(upscaler, emits, (size, size))
    k4_by_shape = counts["k4_by_shape"]
    if k4_by_shape != k4_expected:
        raise AssertionError(f"vid2vid_upscale K4 launches {k4_by_shape}, expected {k4_expected}")
    if counts["k2"]:
        raise AssertionError("K2 launched in vid2vid_upscale, where use_pallas_conv is off")
    # the same upscaler on the vid2vid_plain_conv phase's frames (the loop's
    # frames before the upscale, if the pipeline repeats itself), the two
    # windows' emits (the tail, unblended here, is blended in that run)
    diff_sum, diff_max, clipped = 0, 0, 0
    for i in range(0, up_n - overlap, frames_n - overlap):
        want = upscaler.upscale_batch_device(
            torch.from_numpy(np.stack(plain_frames[i:i + frames_n - overlap])).cuda())
        got = torch.from_numpy(np.stack(up_frames[i:i + frames_n - overlap])).cuda()
        d = (want.int() - got.int()).abs()
        diff_sum += int(d.sum())
        diff_max = max(diff_max, int(d.max()))
        clipped += int(((got == 0) | (got == 255)).sum())
        del want, got, d
    n_values = (up_n - overlap) * up_size * up_size * 3
    # the device time of one emit's upscale, and of the RRDB body within it
    emit_frames = torch.from_numpy(video[:frames_n - overlap]).cuda()
    emit_x = (emit_frames.float() / 255.0).to(torch.bfloat16)
    with torch.no_grad():
        upscale_ms = cuda_ms(torch, lambda: upscaler.upscale_batch_device(emit_frames), 1)
        body_ms = cuda_ms(torch, lambda: rrdb.features(emit_x), 1)
    del emit_frames, emit_x
    phase("vid2vid_upscale", t0, upscaler_build_seconds=round(t_up_build, 4),
          windows=summary_up["windows"], frames_written=summary_up["frames_written"],
          frame_shape=list(up_frames[0].shape), loop_seconds=round(up_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary_up["frames_written"] / up_seconds, 4),
          chunks_per_emit=upscaler.chunk_sizes(frames_n - overlap, size, size),
          upscale_ms_per_frame=upscale_ms / (frames_n - overlap),
          rrdb_body_ms_per_frame=body_ms / (frames_n - overlap),
          share_at_0_or_255=clipped / n_values,
          uint8_diff_vs_plain_conv_upscaled_mean=diff_sum / n_values,
          uint8_diff_vs_plain_conv_upscaled_max=diff_max,
          max_memory_allocated=up_peak, k4_launches=counts["k4"],
          k4_launches_by_shape={str(k): n for k, n in sorted(k4_by_shape.items())},
          timers=summary_up["timers"])
    del up_frames
    torch.cuda.empty_cache()

    # -- the disk build and the CLI: the shipped profiles' path ------------
    from controlanimate_tpu_torch.__main__ import main as cli_main
    from controlanimate_tpu_torch.config import ArchConfig

    t0 = time.perf_counter()
    if UNet3DConfig.from_arch(ArchConfig.from_yaml(INFERENCE_V2),
                              SD15_LCM_UNET_JSON) != models.unet.config:
        raise AssertionError("inference-v2.yaml + the unet config.json do not give the "
                             "window phase's UNet")
    t1 = time.perf_counter()
    snapshot_bytes = write_snapshot(torch, SNAPSHOT, models, text, SD15_LCM_UNET_JSON,
                                    SD_VAE_JSON, {"mm_v2.ckpt": (True, 32),
                                                  "mm_v1.ckpt": (False, 24)})
    # the shipped LCM profile's upscaler and face models: the vid2vid_upscale
    # phase's RealESRGAN, a full-width GFPGANv1.3 (out 512, channel
    # multiplier 2, style 512) and RetinaFace-ResNet50 with BN statistics
    from controlanimate_tpu_torch.models.gfpgan import GFPGANv1Clean

    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(SEED)
    with torch.device("cuda"):
        gfpgan = GFPGANv1Clean()
    init_gfpgan_(torch, gfpgan, fgen)
    retina_ckpt = retinaface_checkpoint(torch, fgen)
    snapshot_bytes.update(write_parallel({
        fname: lambda f=fname, o=obj: save_torch(torch, SNAPSHOT / f, o) for fname, obj in (
            ("RealESRGAN_x4plus_anime_6B.pth", {"params_ema": rrdb.state_dict()}),
            ("GFPGANv1.3.pth", gfpgan_checkpoint(torch, gfpgan)),
            ("detection_Resnet50_Final.pth", retina_ckpt))}))
    face_paths = {"upscaler_model_path": str(SNAPSHOT / "RealESRGAN_x4plus_anime_6B.pth"),
                  "face_enhancer_model_path": str(SNAPSHOT / "GFPGANv1.3.pth"),
                  "face_detector_model_path": str(SNAPSHOT / "detection_Resnet50_Final.pth")}
    height_768 = 768  # video_768 (the controlnet phase's): one whole and one overlap-8 window
    write_frames(np, SNAPSHOT / "frames_512x512", video)
    write_frames(np, SNAPSHOT / "frames_512x768", video_768[:frames_n])
    write_seconds = time.perf_counter() - t1

    def run_cli(tag: str, argv=(), **settings):
        """`python -m controlanimate_tpu_torch --config <profile>` in-process
        on the snapshot: the vid2vid phase's settings, frames from a PNG
        directory, PNGs out (no ffmpeg). Returns (summary, frames written,
        seconds, launch counts, peak memory)."""
        out_dir = ROOT / "build" / "chip_smoke_vid2vid" / tag
        shutil.rmtree(out_dir, ignore_errors=True)
        profile = {
            "output_video_dir": str(out_dir), "prompt": cfg.prompt, "n_prompt": cfg.n_prompt,
            "use_lcm": 1, "steps": steps, "guidance_scale": cfg.guidance_scale,
            "strength": cfg.strength, "overlap_strength": cfg.strength,
            "lcm_origin_steps": cfg.lcm_origin_steps, "dtype": cfg.dtype, "seed": SEED,
            "frame_count": frames_n, "overlap_length": overlap, "upscale": 1,
            "pretrained_lcm_model_path": str(SNAPSHOT), "textual_inversion_paths": [],
            "ffmpeg_path": str(SNAPSHOT / "no-ffmpeg"), **settings}
        path = SNAPSHOT / f"{tag}.yaml"
        path.write_text(json.dumps(profile))  # JSON is YAML
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for module in (fa, ck, mk, uk):
            module.reset_launch_counts()
        t1 = time.perf_counter()
        with redirect_stdout(io.StringIO()):  # the CLI prints its summary
            summary = cli_main(["--config", str(path), *argv])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        counts = {"k1_by_shape": dict(fa.flash_attention.launches_by_shape),
                  "k2_by_shape": dict(ck.conv3x3_fused.launches_by_shape),
                  "k3": mk.motion_module_fused.launches,
                  "k3_by_shape": dict(mk.motion_module_fused.launches_by_shape),
                  "k4": uk.upconv3x3.launches,
                  "k4_by_shape": dict(uk.upconv3x3.launches_by_shape)}
        return (summary, read_frames(np, out_dir / "frames"), seconds, counts,
                torch.cuda.max_memory_allocated())

    def loop_fields(summary, seconds, peak):
        build = summary["timers"]["build_pipeline"]["total_s"]
        return {"cli_seconds": round(seconds, 4), "disk_build_seconds": build,
                "loop_seconds": round(seconds - build, 4),
                "new_frames_per_second_first_window_included": round(
                    summary["frames_written"] / (seconds - build), 4),
                "max_memory_allocated": peak}

    # the controlnet phase's two ControlNets and three more seeded ones (the
    # LCM-LoRA profile's openpose, lineart and MLSD), found under
    # models/ControlNet/, and the HED, lineart, MLSD and OpenPose networks
    # under models/annotators/, from the snapshot root as the working
    # directory
    t1 = time.perf_counter()
    lgen = torch.Generator(device="cuda")
    lgen.manual_seed(SEED + 5)
    lora_nets = dict(zip(LORA_CN_NAMES, [
        net.to(torch.bfloat16)  # the run dtype, as the controlnet phase left its nets
        for net in seeded_controlnets(torch, models.unet.config, 3, "cuda", lgen)]
        + [cn_nets[1]]))
    # the controlnet phase's GLPN as a transformers folder, on a thread
    # beside the other files
    with ThreadPoolExecutor(max_workers=1) as pool:
        glpn_job = pool.submit(write_depth_folder, SNAPSHOT / GLPN_FOLDER, glpn_config, glpn_sd)
        snapshot_bytes.update(write_controlnets(
            torch, SNAPSHOT, {**dict(zip(CN_NAMES, cn_nets)), **lora_nets},
            {"ControlNetHED.pth": hed_net.state_dict(), "sk_model.pth": lineart_net.state_dict(),
             "mlsd_large_512_fp32.pth": mlsd_sd, **pose_sds,
             "table5_pidinet.pth": {"state_dict": {k: v.cpu()
                                                   for k, v in pidi_ckpt["state_dict"].items()}},
             "netG.pth": anime_net.state_dict(), "normalbae/scannet.pt": nb_ckpt}))
        snapshot_bytes[f"{GLPN_FOLDER}/model.safetensors"] = glpn_job.result()
    # the softedge, lineart_anime, normalbae and depth ControlNets are the
    # canny, HED, MLSD and lineart nets' folders: the name selects the
    # annotator
    m13c_sources = (*CN_NAMES, LORA_CN_NAMES[2], LORA_CN_NAMES[1])
    m13c_nets = (*cn_nets, lora_nets[LORA_CN_NAMES[2]], lora_nets[LORA_CN_NAMES[1]])
    for name, net_name in zip(M13C_CN_NAMES, m13c_sources):
        (SNAPSHOT / "models" / "ControlNet" / name.split("/")[-1]).symlink_to(
            net_name.split("/")[-1], target_is_directory=True)
    cn_write_seconds = time.perf_counter() - t1

    # the controlnet phase's native-LCM profile from disk (inference-v2, K2
    # off), its first window: the LCM UNet, VAE, text encoder and
    # motion module read from the snapshot, the two ControlNets and HED from
    # their folders; its frames must equal the controlnet phase's first 8
    with chdir(SNAPSHOT):
        summary, disk_cn_frames, seconds, counts, peak = run_cli(
            "disk_controlnet", ["--max-windows", "1"],
            input_video_path=str(SNAPSHOT / "frames_512x512"), width=size, height=size,
            inference_config_path=str(INFERENCE_V2), motion_module=str(SNAPSHOT / "mm_v2.ckpt"),
            use_pallas_conv=0, **cn_settings)
    n_cli = frames_n - overlap  # a run stopped by --max-windows keeps 8 for a resume
    if summary["windows"] != 1 or len(disk_cn_frames) != n_cli:
        raise AssertionError(f"the native-LCM ControlNet CLI run wrote {len(disk_cn_frames)} "
                             f"frames in {summary['windows']} windows, not {n_cli} in 1")
    cn_cli_k1_expected = expected_k1_launches(1, 0, steps, frames_n, overlap,
                                              controlnets=len(CN_NAMES))
    if counts["k1_by_shape"] != cn_cli_k1_expected or counts["k2_by_shape"] or counts["k3"]:
        raise AssertionError(f"native-LCM ControlNet CLI K1 launches {counts['k1_by_shape']}, "
                             f"expected {cn_cli_k1_expected}, or K2 or K3 launched")
    diff = np.abs(np.stack(disk_cn_frames).astype(np.int16)
                  - np.stack(cn_frames[:n_cli]).astype(np.int16))
    fields_cn = {"controlnets": list(CN_NAMES),
                 "controlnet_write_seconds": round(cn_write_seconds, 4),
                 "frames_written": summary["frames_written"],
                 "uint8_diff_vs_controlnet_max": int(diff.max()),
                 "uint8_diff_vs_controlnet_mean": float(diff.mean()),
                 "k1_launches": sum(counts["k1_by_shape"].values())}
    if diff.max():
        # the injected pipeline again: the card's own run-to-run difference
        _, again, _, _, _, _ = run_vid2vid(False, "controlnet_again", engine_models=cn_models,
                                           max_windows=1, **cn_settings)
        rerun = np.abs(np.stack(again).astype(np.int16)
                       - np.stack(cn_frames[:n_cli]).astype(np.int16))
        fields_cn["injected_rerun_diff_max"] = int(rerun.max())
        if diff.max() > rerun.max():
            raise AssertionError(f"the native-LCM ControlNet CLI run's frames differ from the "
                                 f"controlnet phase's by {int(diff.max())}, two injected runs "
                                 f"by {int(rerun.max())}")
    fields_cn.update(loop_fields(summary, seconds, peak), timers=summary["timers"])
    del disk_cn_frames, diff, cn_frames

    # the same profile naming the softedge, lineart_anime, normalbae and
    # depth ControlNets (the canny, HED, MLSD and lineart nets' folders), its
    # annotators read from table5_pidinet.pth, netG.pth,
    # normalbae/scannet.pt and GLPN (b4) from the folder
    # CONTROLANIMATE_DEPTH_MODEL names, one window, against the injected
    # pipeline with the same nets and the controlnet phase's annotators
    se_settings = {"controlnets": M13C_CN_NAMES, "cond_scale": M13C_CN_SCALES}
    with chdir(SNAPSHOT), env_set(DEPTH_MODEL_ENV, str(SNAPSHOT / GLPN_FOLDER)):
        summary, disk_se_frames, seconds, counts, peak = run_cli(
            "disk_m13c", ["--max-windows", "1"],
            input_video_path=str(SNAPSHOT / "frames_512x512"), width=size, height=size,
            inference_config_path=str(INFERENCE_V2), motion_module=str(SNAPSHOT / "mm_v2.ckpt"),
            use_pallas_conv=0, **se_settings)
    if summary["windows"] != 1 or len(disk_se_frames) != n_cli:
        raise AssertionError(f"the softedge/lineart_anime/normalbae/depth CLI run wrote "
                             f"{len(disk_se_frames)} frames in {summary['windows']} windows, "
                             f"not {n_cli} in 1")
    # the depth annotator's GLPN layers, fp32
    glpn_cli_k1 = glpn_k1_launches(GLPN_B4, frames_n, (size, size))
    se_k1_expected = dict(Counter(expected_k1_launches(
        1, 0, steps, frames_n, overlap, controlnets=len(M13C_CN_NAMES))) + Counter(glpn_cli_k1))
    if counts["k1_by_shape"] != se_k1_expected or counts["k2_by_shape"] or counts["k3"]:
        raise AssertionError(f"softedge/lineart_anime/normalbae/depth CLI K1 launches "
                             f"{counts['k1_by_shape']}, expected {se_k1_expected}, or K2 or K3 "
                             f"launched")
    se_models = EngineModels(unet=models.unet, vae=models.vae, controlnets=list(m13c_nets),
                             annotators=[softedge, lineart_anime, normalbae, depth_glpn])
    _, se_injected, _, _, _, _ = run_vid2vid(False, "m13c", engine_models=se_models,
                                             max_windows=1, **se_settings)
    diff = np.abs(np.stack(disk_se_frames).astype(np.int16)
                  - np.stack(se_injected).astype(np.int16))
    fields_se = {"controlnets": list(M13C_CN_NAMES), "frames_written": summary["frames_written"],
                 "uint8_diff_vs_injected_max": int(diff.max()),
                 "uint8_diff_vs_injected_mean": float(diff.mean()),
                 "k1_launches": sum(counts["k1_by_shape"].values()),
                 "depth_k1_launches": {str(k): counts["k1_by_shape"].get(k, 0)
                                       for k in sorted(glpn_cli_k1)}}
    if diff.max():
        _, again, _, _, _, _ = run_vid2vid(False, "m13c_again", engine_models=se_models,
                                           max_windows=1, **se_settings)
        rerun = np.abs(np.stack(again).astype(np.int16)
                       - np.stack(se_injected).astype(np.int16))
        fields_se["injected_rerun_diff_max"] = int(rerun.max())
        if diff.max() > rerun.max():
            raise AssertionError(f"the softedge/lineart_anime/normalbae/depth CLI run's frames "
                                 f"differ from the injected pipeline's by {int(diff.max())}, two "
                                 f"injected runs by {int(rerun.max())}")
    fields_se.update(loop_fields(summary, seconds, peak), timers=summary["timers"])
    depth_cli_k1 = {k: counts["k1_by_shape"][k] for k in glpn_cli_k1}
    del disk_se_frames, se_injected, diff, se_models, depth_glpn

    # the LCM-LoRA profile's files (SampleConfigLCMLoRA.yaml: a LoRA from
    # `lora_model_paths`, its four ControlNets: openpose at 1.0, lineart at
    # 0.35, MLSD at 1.0, HED at 0.4; 512x768, `upscale` 2, the face enhancer
    # with `upscale_first` 1) on the same snapshot read as
    # `pretrained_model_path`: the injected pipeline after the LoRA's fusion,
    # with the same four nets and annotators, and an Upscaler read from the
    # same files. The IP-Adapter run below builds the same LoRA, ControlNets
    # and annotators from disk through the CLI, every tensor of that build
    # held against the injected ones, and runs the profile's LCMScheduler
    # tail under CFG at B*F = 32 (its window in guess mode).
    import copy

    import controlanimate_tpu_torch.pipelines.facade as facade_module
    from controlanimate_tpu_torch.config import RunConfig
    from controlanimate_tpu_torch.models.clip import (CLIPVisionConfig,
                                                      CLIPVisionModelWithProjection)
    from controlanimate_tpu_torch.pipelines.facade import TextStack
    from controlanimate_tpu_torch.pipelines.ip_adapter import (
        IPAdapter, ImageProjModel, attn2_paths_in_checkpoint_order)
    from controlanimate_tpu_torch.weights.lora import fuse_lora, split_lora_by_component

    t1 = time.perf_counter()
    unet_state = models.unet.state_dict()
    unet_2d = {k: v.cpu() for k, v in unet_state.items() if "motion_modules" not in k}
    te_state = {k: v.cpu() for k, v in text.model.state_dict().items()}
    lora_sd = kohya_lora(torch, unet_2d, te_state, torch.Generator().manual_seed(SEED + 4))
    lora_path = SNAPSHOT / "lcm_lora.safetensors"
    snapshot_bytes[lora_path.name] = save_safetensors(lora_path, lora_sd)
    lora_write_seconds = time.perf_counter() - t1
    lora_cn_settings = {"controlnets": LORA_CN_NAMES, "cond_scale": LORA_CN_SCALES}
    lora_face = {"use_face_enhancer": True, "upscale_first": True}
    t1 = time.perf_counter()
    parts = split_lora_by_component(lora_sd)
    fused_unet, fused_n = fuse_lora(unet_2d, parts["unet"])
    fused_te, fused_te_n = fuse_lora(te_state, parts["text_encoder"])
    fuse_seconds = time.perf_counter() - t1
    with torch.device("meta"):
        unet_lora = UNet3DConditionModel(models.unet.config)
    unet_lora.load_state_dict(
        {k: fused_unet[k].to("cuda", torch.bfloat16) if k in fused_unet else v
         for k, v in unet_state.items()}, assign=True)
    text_lora = copy.deepcopy(text.model)
    text_lora.load_state_dict({k: v.to("cuda", torch.bfloat16 if v.is_floating_point()
                                       else v.dtype) for k, v in fused_te.items()})
    lora_text = TextStack(text.tokenizer, text_lora)
    lora_models = EngineModels(unet=unet_lora, vae=models.vae,
                               controlnets=list(lora_nets.values()),
                               annotators=[openpose_ann, lineart, mlsd_ann, hed])
    lora_upscaler = Upscaler(2.0, model_path=face_paths["upscaler_model_path"],
                             dtype=torch.bfloat16, device="cuda", use_face_enhancer=True,
                             upscale_first=True,
                             face_enhancer_model_path=face_paths["face_enhancer_model_path"],
                             face_detector_model_path=face_paths["face_detector_model_path"])
    lora_twin = {"engine_models": lora_models, "text_stack": lora_text, "max_windows": 1,
                 "upscaler": lora_upscaler, "source": video_768, "width": size,
                 "height": height_768, **lora_face, **LCM_LORA_PROFILE, **lora_cn_settings}
    latent = (height_768 // 8, size // 8)
    # one window's emit (8 frames) through the upscaler: the IP-Adapter run's
    # K4 launches
    lora_k4_expected = expected_k4_launches(lora_upscaler, [frames_n - overlap],
                                            (height_768, size))
    fields_lora = {"controlnets": list(LORA_CN_NAMES), "cond_scale": list(LORA_CN_SCALES),
                   "lora_write_seconds": round(lora_write_seconds, 4),
                   "lora_layers_fused": fused_n + fused_te_n,
                   "host_fuse_seconds": round(fuse_seconds, 4)}
    del unet_2d, te_state, lora_sd, parts, fused_unet, fused_te, cn_models, cn_nets

    # the IP-Adapter profile as shipped (SampleConfigIPAdapter.yaml: the
    # LCM-LoRA profile's files, ControlNets in guess mode, 12 steps, CFG
    # 1.35, `use_ipadapter` with ipa_scale 0.65 and `do_initial_generation`)
    # through the CLI for one window, which is the initial double pass: a
    # seeded full-width CLIP ViT-H/14 image encoder (HF keys, bf16) and a
    # base-layout ip-adapter_sd15.bin (4 tokens, the UNet's 16
    # cross-attentions) where the profile names them. Against the injected
    # pipeline of the same tensors, its adapter read from the same files.
    shipped = RunConfig.from_yaml(ROOT / "configs" / "prompts" / "SampleConfigIPAdapter.yaml")
    differs = {k: (v, getattr(shipped, k)) for k, v in {
        **IP_ADAPTER_PROFILE, **lora_cn_settings, **lora_face, "width": size,
        "height": height_768, "upscale": 2.0, "lora_weights": (1.0,),
        "overlap_length": overlap, "frame_count": frames_n,
        "lcm_origin_steps": cfg.lcm_origin_steps}.items()
        if getattr(shipped, k) != (tuple(v) if isinstance(v, (list, tuple)) else v)}
    if differs:
        raise AssertionError(f"the IP-Adapter run's settings are not the shipped profile's: "
                             f"{differs}")
    t1 = time.perf_counter()
    igen = torch.Generator(device="cuda")
    igen.manual_seed(SEED + 6)
    vcfg = CLIPVisionConfig()
    with torch.device("cuda"):
        vision = CLIPVisionModelWithProjection(vcfg).to(torch.bfloat16)
        proj = ImageProjModel(models.unet.config.cross_attention_dim, vcfg.projection_dim,
                              4).to(torch.bfloat16)
    for module in (vision, proj):
        init_weights_(torch, module, igen)
    ip_sd = {}
    for i, path in enumerate(attn2_paths_in_checkpoint_order(models.unet.config)):
        to_k = models.unet.get_submodule(f"{path}.transformer_blocks.0.attn2").to_k.weight
        for name in ("to_k_ip", "to_v_ip"):
            ip_sd[f"{2 * i + 1}.{name}.weight"] = torch.randn(
                to_k.shape, generator=igen, device="cuda", dtype=torch.bfloat16
            ) / math.sqrt(to_k.shape[1])
    encoder_dir = SNAPSHOT / IP_ADAPTER_PROFILE["ipadapter_image_encoder_path"]
    encoder_dir.mkdir(parents=True)
    (encoder_dir / "config.json").write_text(json.dumps({
        "hidden_size": vcfg.hidden_size, "intermediate_size": vcfg.intermediate_size,
        "num_attention_heads": vcfg.num_heads, "num_hidden_layers": vcfg.num_layers,
        "image_size": vcfg.image_size, "patch_size": vcfg.patch_size,
        "projection_dim": vcfg.projection_dim, "layer_norm_eps": vcfg.layer_norm_eps,
        "hidden_act": "gelu"}))
    ip_ckpt = SNAPSHOT / IP_ADAPTER_PROFILE["ipadapter_ckpt_path"]
    snapshot_bytes.update(write_parallel({
        "image_encoder": lambda: save_safetensors(encoder_dir / "model.safetensors",
                                                  vision.state_dict()),
        ip_ckpt.name: lambda: save_torch(torch, ip_ckpt, {
            "image_proj": {k: v.cpu() for k, v in proj.state_dict().items()},
            "ip_adapter": {k: v.cpu() for k, v in ip_sd.items()}})}))
    ip_write_seconds = time.perf_counter() - t1
    vision_params = sum(p.numel() for p in vision.parameters())
    # the injected twin's UNet: the fused one with the checkpoint's K/V
    with torch.device("meta"):
        unet_ip = UNet3DConditionModel(dataclasses.replace(models.unet.config, ip_tokens=4))
    unet_ip.load_state_dict({**unet_lora.state_dict(), **IPAdapter(
        None, proj, ip_sd).unet_weights(unet_ip.config)}, assign=True)
    ip_settings = {**IP_ADAPTER_PROFILE, "use_pallas_conv": 0, "upscale": 2, **lora_face,
                   **lora_cn_settings, **face_paths}
    cli_pipes = []  # the pipeline the CLI builds, kept for the tensor check

    class KeptPipeline(ControlAnimatePipeline):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            cli_pipes.append(self)

    facade_module.ControlAnimatePipeline = KeptPipeline
    try:
        with chdir(SNAPSHOT):
            summary, ip_frames, seconds, counts, peak = run_cli(
                "disk_ip_adapter", ["--max-windows", "1"],
                input_video_path=str(SNAPSHOT / "frames_512x768"), width=size,
                height=height_768, inference_config_path=str(INFERENCE_V2),
                motion_module=str(SNAPSHOT / "mm_v2.ckpt"), pretrained_model_path=str(SNAPSHOT),
                lora_model_paths=[str(lora_path)], lora_weights=[1.0], **ip_settings)
    finally:
        facade_module.ControlAnimatePipeline = ControlAnimatePipeline
    # the CLI's disk build (the LoRA fused on the host, the IP-Adapter's K/V
    # in the UNet, the ControlNets' folders, the image encoder) tensor by
    # tensor against the injected models
    (cli_pipe,) = cli_pipes
    mismatched = []
    for name, mine, want in (
            ("unet", cli_pipe.models.unet, unet_ip), ("vae", cli_pipe.models.vae, models.vae),
            ("text_encoder", cli_pipe.text.model, text_lora),
            ("image_encoder", cli_pipe.ip_adapter.vision_model, vision),
            ("image_proj", cli_pipe.ip_adapter.proj_model, proj),
            *((f"controlnet {n}", a, b) for n, a, b in zip(
                LORA_CN_NAMES, cli_pipe.models.controlnets, lora_nets.values()))):
        mine_sd, want_sd = mine.state_dict(), want.state_dict()
        if set(mine_sd) != set(want_sd) or not all(torch.equal(mine_sd[k], v)
                                                   for k, v in want_sd.items()):
            mismatched.append(name)
    if mismatched:
        raise AssertionError(f"the IP-Adapter profile's disk build differs from the injected "
                             f"models in {mismatched}")
    del cli_pipes, cli_pipe, mine_sd, want_sd, vision, proj
    with chdir(SNAPSHOT):
        # the adapter read alone, for the injected twin
        t1 = time.perf_counter()
        ip_adapter = IPAdapter.from_config(RunConfig(**IP_ADAPTER_PROFILE), "cuda",
                                           torch.bfloat16)
        torch.cuda.synchronize()
        ip_build_seconds = time.perf_counter() - t1
    ip_window_steps = [make_scheduler("LCMScheduler", make_schedule(), IP_ADAPTER_PROFILE["steps"],
                                      strength=s, lcm_origin_steps=cfg.lcm_origin_steps,
                                      strength_mode="tail").num_steps
                       for s in (IP_ADAPTER_PROFILE["strength"],
                                 IP_ADAPTER_PROFILE["overlap_strength"])]
    # the UNet at B*F = 32 on both passes, the ControlNets in guess mode at
    # B*F = 16, the second pass's encode of its 8 anchors, and the image
    # encoder once (the first pass's tokens are zeros)
    ip_k1 = counts["k1_by_shape"]
    ip_k1_expected = expected_cfg_k1_launches(ip_window_steps, frames_n, [overlap], latent=latent,
                                              controlnets=len(LORA_CN_NAMES), guess_mode=True,
                                              embeds=1)
    if ip_k1 != ip_k1_expected or counts["k2_by_shape"] or counts["k3"]:
        raise AssertionError(f"IP-Adapter CLI K1 launches {ip_k1}, expected {ip_k1_expected}, "
                             f"or K2 or K3 launched")
    ip_k4 = counts["k4_by_shape"]
    if ip_k4 != lora_k4_expected:
        raise AssertionError(f"IP-Adapter CLI K4 launches {ip_k4}, expected {lora_k4_expected}")
    if (summary["windows"] != 1 or len(ip_frames) != frames_n - overlap
            or any(f.shape != (2 * height_768, 2 * size, 3) for f in ip_frames)):
        raise AssertionError(f"the IP-Adapter CLI run wrote {len(ip_frames)} frames in "
                             f"{summary['windows']} windows")
    ip_twin = {**lora_twin, "engine_models": dataclasses.replace(lora_models, unet=unet_ip),
               "ip_adapter": ip_adapter, **IP_ADAPTER_PROFILE}
    _, injected, injected_seconds, _, _, _ = run_vid2vid(False, "ip_adapter", **ip_twin)
    diff = np.abs(np.stack(ip_frames).astype(np.int16) - np.stack(injected).astype(np.int16))
    # the image encoder alone on an anchor, by CUDA events (uncond cached)
    anchor = torch.from_numpy(video_768[frames_n - overlap]).cuda()
    tower_ms = cuda_ms(torch, lambda: ip_adapter.embed_image(anchor), 5)
    fields_ip = {"settings": {k: v for k, v in IP_ADAPTER_PROFILE.items()
                              if not k.endswith("_path")},
                 "frame_shape": [2 * height_768, 2 * size, 3],
                 "image_encoder_params": vision_params, "ip_tokens": ip_adapter.num_tokens,
                 "ip_files_write_seconds": round(ip_write_seconds, 4),
                 "adapter_build_seconds": round(ip_build_seconds, 4),
                 "image_encoder_ms_per_embed": tower_ms, "window_steps": ip_window_steps,
                 "faces": summary["faces"], "frames_written": summary["frames_written"],
                 "upscale_seconds": summary["timers"]["upscale"]["total_s"],
                 "k4_launches": sum(ip_k4.values()), "k1_launches": sum(ip_k1.values()),
                 "k1_image_encoder_launches": ip_k1.get(VISION_K1_SHAPE, 0),
                 "k1_launches_by_shape": {str(k): n for k, n in sorted(ip_k1.items())},
                 "injected_loop_seconds": round(injected_seconds, 4),
                 "uint8_diff_vs_injected_max": int(diff.max()),
                 "uint8_diff_vs_injected_mean": float(diff.mean()),
                 "openpose_last_map": dict(openpose_ann.stats)}
    if diff.max():
        _, again, _, _, _, _ = run_vid2vid(False, "ip_adapter_again", **ip_twin)
        rerun = np.abs(np.stack(again).astype(np.int16) - np.stack(injected).astype(np.int16))
        fields_ip["injected_rerun_diff_max"] = int(rerun.max())
        if diff.max() > rerun.max():
            raise AssertionError(f"the IP-Adapter CLI run's frames differ from the injected "
                                 f"pipeline's by {int(diff.max())}, two injected runs by "
                                 f"{int(rerun.max())}")
    fields_ip.update(loop_fields(summary, seconds, peak), timers=summary["timers"])
    del (unet_state, unet_lora, text_lora, unet_ip, lora_models, lora_text, ip_adapter, ip_sd,
         ip_frames, injected, diff, anchor, hed, hed_net, lora_nets, lineart, lineart_net,
         mlsd_ann, mlsd_sd, openpose_ann, pose_sds, lora_upscaler, lora_twin, ip_twin)
    torch.cuda.empty_cache()

    # the whole shipped LCM profile (SampleConfigLCM.yaml): 512x768 on
    # inference-v1.yaml (no mid-block motion module, PE 24 long), K2 on,
    # upscale 2 (RealESRGAN x4 with its tail on K4, then Lanczos4 to
    # 1024x1536), the face enhancer with upscale_first 1
    latent = (height_768 // 8, size // 8)
    up_h, up_w = 2 * height_768, 2 * size
    summary, frames_768, seconds, counts, peak = run_cli(
        "disk_512x768", input_video_path=str(SNAPSHOT / "frames_512x768"), width=size,
        height=height_768, inference_config_path=str(INFERENCE_V1),
        motion_module=str(SNAPSHOT / "mm_v1.ckpt"), use_pallas_conv=1, upscale=2,
        use_face_enhancer=1, upscale_first=1, **face_paths)
    if summary["frames_written"] != frames_n or len(frames_768) != frames_n:
        raise AssertionError(f"the 512x768 CLI run wrote {summary['frames_written']} frames "
                             f"({len(frames_768)} PNGs) of {frames_n}")
    if any(f.shape != (up_h, up_w, 3) for f in frames_768):
        raise AssertionError(f"the 512x768 CLI run's frames are not ({up_h}, {up_w}, 3)")
    if float(np.stack(frames_768).std()) == 0.0:
        raise AssertionError("the 512x768 CLI run's frames are constant")
    if summary["faces"]["frames_searched"] != frames_n:
        raise AssertionError(f"the face detector searched {summary['faces']} frames")
    k1_768 = counts["k1_by_shape"]
    k1_768_expected = expected_k1_launches(1, 0, steps, frames_n, overlap, latent=latent)
    if k1_768 != k1_768_expected:
        raise AssertionError(f"512x768 K1 launches {k1_768}, expected {k1_768_expected}")
    k2_768 = counts["k2_by_shape"]
    k2_768_expected = expected_k2_launches(models.vae, (height_768, size), frames_n, overlap, 1, 0)
    if k2_768 != k2_768_expected:
        raise AssertionError(f"512x768 K2 launches {k2_768}, expected {k2_768_expected}")
    if counts["k3"]:
        raise AssertionError(f"the 512x768 CLI run launched K3: {counts}")
    # the injected pipeline of the same weights on inference-v1.yaml (the
    # window phase's UNet without the mid block's motion module, parameters
    # shared), same settings and noise, through an Upscaler read from the
    # same files: every frame equal
    t1 = time.perf_counter()
    arch_v1 = ArchConfig.from_yaml(INFERENCE_V1)
    with torch.device("meta"):
        unet_v1 = UNet3DConditionModel(UNet3DConfig.from_arch(arch_v1, SD15_LCM_UNET_JSON))
    v2_state = models.unet.state_dict()
    unet_v1.load_state_dict({k: v2_state[k] for k in unet_v1.state_dict()}, assign=True)
    v1_cfg = cfg.replace(use_pallas_conv=True, seed=SEED, overlap_strength=cfg.strength,
                         width=size, height=height_768, upscale=2.0, use_face_enhancer=True,
                         upscale_first=True,
                         output_video_dir=str(ROOT / "build" / "chip_smoke_vid2vid" / "v1"))
    v1_pipe = ControlAnimatePipeline(
        v1_cfg, models=EngineModels(unet=unet_v1.to("cuda"), vae=models.vae),
        text_stack=text, arch=arch_v1, device="cuda")
    v1_upscaler = Upscaler(2.0, model_path=face_paths["upscaler_model_path"],
                           dtype=torch.bfloat16, device="cuda", use_face_enhancer=True,
                           upscale_first=True,
                           face_enhancer_model_path=face_paths["face_enhancer_model_path"],
                           face_detector_model_path=face_paths["face_detector_model_path"])
    k4_768 = counts["k4_by_shape"]
    k4_768_expected = expected_k4_launches(v1_upscaler, [frames_n - overlap] * 2,
                                           (height_768, size))
    if k4_768 != k4_768_expected:
        raise AssertionError(f"512x768 K4 launches {k4_768}, expected {k4_768_expected}")
    v1_sink = ArrayFrameSink()
    v2v.vid2vid(config=v1_cfg, pipeline=v1_pipe,
                frame_source=ArrayFrameSource(video_768[:frames_n]),
                frame_sink=v1_sink, upscaler=v1_upscaler)
    injected_v1_seconds = time.perf_counter() - t1  # its build included
    if len(v1_sink.frames) != len(frames_768):
        raise AssertionError(f"the injected v1 run wrote {len(v1_sink.frames)} frames")
    diff_v1 = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                  for a, b in zip(frames_768, v1_sink.frames))
    if diff_v1:
        raise AssertionError(f"the 512x768 CLI run's frames differ from the injected v1 "
                             f"pipeline's through the same upscaler by {diff_v1}")
    # the detector alone on an upscaled frame, by CUDA events
    detector = v1_upscaler.face_enhancer.detector
    frame_up = torch.from_numpy(frames_768[0]).cuda()
    detector_ms = cuda_ms(torch, lambda: detector.detect_faces(frame_up), 5)
    fields_768 = {**loop_fields(summary, seconds, peak), "frame_shape": [up_h, up_w, 3],
                  "uint8_diff_vs_injected_v1_max": 0,
                  "injected_v1_seconds": round(injected_v1_seconds, 4),
                  "upscale_seconds": summary["timers"]["upscale"]["total_s"],
                  "detector_ms_per_frame": detector_ms, "faces": summary["faces"],
                  "k1_launches": sum(k1_768.values()), "k2_launches": sum(k2_768.values()),
                  "k4_launches": sum(k4_768.values()),
                  "k1_launches_by_shape": {str(k): n for k, n in sorted(k1_768.items())},
                  "k2_launches_by_shape": {str(k): n for k, n in sorted(k2_768.items())},
                  "k4_launches_by_shape": {str(k): n for k, n in sorted(k4_768.items())},
                  "timers": summary["timers"]}
    del v1_pipe, v1_sink, v1_upscaler, detector, frame_up

    # the shipped SampleConfigMultiChip.yaml through the CLI without its
    # mesh_shape (one card; JAX's make_mesh refuses [4, 2] on one device
    # too): 4 segments of one 16-frame 512x512 window each as one batched
    # window (B*F = 64), native LCM at 4 steps, inference-v1.yaml with
    # mm_v1.ckpt, the motion modules on K3. Its frames against the injected
    # pipeline's S = 4 run of the same weights, which is timed against the
    # sequential loop over each segment alone.
    import yaml

    seg_shipped = yaml.safe_load((ROOT / "configs" / "prompts"
                                  / "SampleConfigMultiChip.yaml").read_text())
    seg_n = 4 * frames_n
    if (seg_shipped.pop("mesh_shape") != [4, 2] or seg_shipped["parallel_segments"] != 4
            or (seg_shipped["width"], seg_shipped["height"]) != (size, size)
            or (seg_shipped["frame_count"], seg_shipped["overlap_length"]) != (frames_n, overlap)
            or seg_shipped["steps"] != steps or not seg_shipped["use_lcm"]
            or seg_shipped["controlnets"]
            or Path(seg_shipped["inference_config_path"]).name != INFERENCE_V1.name):
        raise AssertionError(f"SampleConfigMultiChip.yaml is not the profile this run drives: "
                             f"{seg_shipped}")
    # the vid2vid phase's 40 frames (their PNGs copied) and 24 more
    t1 = time.perf_counter()
    extra = synthetic_video(np, seg_n - len(video), size, size, SEED + 9)
    video_seg = np.concatenate([video, extra])
    (SNAPSHOT / "frames_segments").mkdir()
    for i in range(len(video)):
        shutil.copyfile(SNAPSHOT / "frames_512x512" / f"{i + 1:04d}.png",
                        SNAPSHOT / "frames_segments" / f"{i + 1:04d}.png")
    write_frames(np, SNAPSHOT / "frames_segments", extra, start=len(video))
    seg_write_seconds = time.perf_counter() - t1
    seg_settings = {**{k: v for k, v in seg_shipped.items() if k != "output_video_dir"},
                    "input_video_path": str(SNAPSHOT / "frames_segments"),
                    "pretrained_lcm_model_path": str(SNAPSHOT),
                    "inference_config_path": str(INFERENCE_V1),
                    "motion_module": str(SNAPSHOT / "mm_v1.ckpt"),
                    "ffmpeg_path": str(SNAPSHOT / "no-ffmpeg"), "textual_inversion_paths": []}
    with motion_env(True):
        summary, seg_frames, seconds, counts, peak = run_cli("disk_segments", **seg_settings)
    if (summary["segments"] != 4 or summary["windows"] != 1
            or summary["frames_written"] != seg_n or len(seg_frames) != seg_n
            or any(f.shape != (size, size, 3) for f in seg_frames)):
        raise AssertionError(f"the segment CLI run wrote {len(seg_frames)} frames: {summary}")
    if float(np.stack(seg_frames).std()) == 0.0:
        raise AssertionError("the segment CLI run's frames are constant")
    seg_k3 = counts["k3_by_shape"]
    seg_k3_expected = expected_k3_launches(unet_v1, size // 8, frames_n, steps, 1, batch=4)
    seg_chunk = ControlAnimatePipeline.pick_decode_chunk(seg_n, size * size)
    seg_k1 = counts["k1_by_shape"]
    seg_k1_expected = expected_k1_launches(1, 0, steps, frames_n, overlap, batch=4,
                                           decode_chunk=seg_chunk)
    if seg_k3 != seg_k3_expected or sum(seg_k3.values()) != 80:
        raise AssertionError(f"segment CLI K3 launches {seg_k3}, expected {seg_k3_expected} "
                             f"(80: 20 v1 motion modules x 4 steps)")
    if seg_k1 != seg_k1_expected or counts["k2_by_shape"]:
        raise AssertionError(f"segment CLI K1 launches {seg_k1}, expected {seg_k1_expected}, "
                             f"or K2 launched")
    fields_seg = {**loop_fields(summary, seconds, peak), "segments": summary["segments"],
                  "windows": summary["windows"], "frames_written": summary["frames_written"],
                  "frames_write_seconds": round(seg_write_seconds, 4), "decode_chunk": seg_chunk,
                  "k1_launches": sum(seg_k1.values()), "k3_launches": sum(seg_k3.values()),
                  "k1_launches_by_shape": {str(k): n for k, n in sorted(seg_k1.items())},
                  "k3_launches_by_shape": {str(k): n for k, n in sorted(seg_k3.items())},
                  "timers": summary["timers"]}
    # the injected pipeline of the same weights (the v1 UNet above), the
    # profile as the CLI read it: the batched run, then the sequential loop
    # on each segment's 16 frames alone
    seg_cfg = RunConfig.from_yaml(SNAPSHOT / "disk_segments.yaml")
    with motion_env(True):
        seg_pipe = ControlAnimatePipeline(
            seg_cfg, models=EngineModels(unet=unet_v1, vae=models.vae), text_stack=text,
            arch=arch_v1, device="cuda")

    def segment_loop(config, source, tag):
        sink = ArrayFrameSink()
        config = config.replace(output_video_dir=str(ROOT / "build" / "chip_smoke_vid2vid" / tag))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        summary = v2v.vid2vid(config=config, pipeline=seg_pipe,
                              frame_source=ArrayFrameSource(source), frame_sink=sink)
        torch.cuda.synchronize()
        return (summary, sink.frames, time.perf_counter() - t1,
                torch.cuda.max_memory_allocated())

    _, batched, batched_seconds, batched_peak = segment_loop(seg_cfg, video_seg, "segments")
    diff_seg = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                   for a, b in zip(seg_frames, batched))
    if len(batched) != seg_n or diff_seg:
        raise AssertionError(f"the segment CLI run's frames differ from the injected S = 4 "
                             f"run's by {diff_seg} ({len(batched)} frames)")
    sequential, seq_seconds, seq_peak = [], 0.0, 0
    for s in range(4):
        _, part, part_seconds, part_peak = segment_loop(
            seg_cfg.replace(parallel_segments=0), video_seg[s * frames_n:(s + 1) * frames_n],
            f"segment_{s}")
        sequential += part
        seq_seconds += part_seconds
        seq_peak = max(seq_peak, part_peak)
    diff = np.abs(np.stack(batched).astype(np.int16) - np.stack(sequential).astype(np.int16))
    fields_seg.update(
        uint8_diff_vs_injected_max=0, injected_batched_loop_seconds=round(batched_seconds, 4),
        injected_batched_new_frames_per_second=round(seg_n / batched_seconds, 4),
        injected_batched_max_memory_allocated=batched_peak,
        sequential_loop_seconds=round(seq_seconds, 4),
        sequential_new_frames_per_second=round(seg_n / seq_seconds, 4),
        sequential_max_memory_allocated=seq_peak,
        uint8_diff_batched_vs_sequential_max=int(diff.max()),
        uint8_diff_batched_vs_sequential_mean=float(diff.mean()))
    del (unet_v1, v2_state, seg_pipe, seg_frames, batched, sequential, diff, video_seg,
         seg_shipped)
    shutil.rmtree(SNAPSHOT)
    phase("disk", t0, snapshot_write_seconds=round(write_seconds, 4),
          snapshot_bytes=snapshot_bytes, cli_controlnet=fields_cn,
          cli_m13c_annotators=fields_se,
          lcm_lora_build=fields_lora, cli_ip_adapter=fields_ip, cli_512x768=fields_768,
          cli_segments=fields_seg)
    del plain_frames
    torch.cuda.empty_cache()

    # -- the face step at full width on the upscaled frames -----------------
    from controlanimate_tpu_torch.models import face_align
    from controlanimate_tpu_torch.models.gfpgan import FaceEnhancer
    from controlanimate_tpu_torch.models.retinaface import (RetinaFaceDetector, RetinaFaceNet,
                                                            fp32_convs, retinaface_state_dict)

    t0 = time.perf_counter()
    with torch.device("cuda"):
        retina = RetinaFaceNet()
    retina.load_state_dict(retinaface_state_dict(retina_ckpt))
    fe = FaceEnhancer(model=gfpgan, detector=RetinaFaceDetector(model=retina, device="cuda"),
                      device="cuda")
    face_frames = [torch.from_numpy(f).cuda() for f in frames_768[:FACE_FRAMES + 1]]
    with torch.no_grad():  # GFPGAN's fp32 output on one crop, before the uint8 rounding
        crop, _ = face_align.align_face(face_frames[0], face_landmarks(
            np, up_h, up_w, FACES)[0], fe.face_size)
        with fp32_convs():
            y = fe.model((crop.float() / 127.5 - 1.0).permute(2, 0, 1)[None], fe.noise)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("GFPGAN's output is not finite")
    time_face_steps(torch, np, fe, face_frames[:1])  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_ms = time_face_steps(torch, np, fe, face_frames[1:])
    n_faces = FACE_FRAMES * len(FACES)
    phase("face", t0, frame_shape=[up_h, up_w, 3], frames=FACE_FRAMES,
          faces_given_per_frame=len(FACES), faces_found=steps_ms["faces_found"],
          detector_ms_per_frame=steps_ms["ms"]["detect"] / FACE_FRAMES,
          align_ms_per_face=steps_ms["ms"]["align"] / n_faces,
          gfpgan_ms_per_face=steps_ms["ms"]["gfpgan"] / n_faces,
          paste_ms_per_face=steps_ms["ms"]["paste"] / n_faces,
          ms_per_frame=sum(steps_ms["ms"].values()) / FACE_FRAMES,
          gfpgan_params=sum(p.numel() for p in gfpgan.parameters()),
          gfpgan_output_abs_max=float(y.abs().max()),
          max_memory_allocated=torch.cuda.max_memory_allocated())
    del fe, gfpgan, retina, retina_ckpt, face_frames, frames_768, crop, y
    torch.cuda.empty_cache()

    # -- K1 at every shape the window phase launched it with --------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    # the plain version is timed on the main path's shapes and the image
    # encoder's (the 512x768, CFG and odd shapes are checked against it)
    launched = (set(by_shape) | set(k1_768) | set(cfg_k1) | set(ip_k1) | set(seg_k1)
                | set(var_k1))
    untimed_k1 = ((launched | set(ODD_SHAPES) | set(K1_GRID_SHAPES)) - set(by_shape)
                  - {VISION_K1_SHAPE})
    # fp32 K1 runs in the reference phase alone, at small shapes: the
    # launched shapes are checked in bf16, the odd ones in both
    check_seconds = 0.0  # of the phase's seconds, those of the checks
    for shape in sorted(launched) + ODD_SHAPES + K1_GRID_SHAPES:
        t1 = time.perf_counter()
        err_bf16 = check_kernel(torch, fa, shape, torch.bfloat16, gen)
        err_fp32 = (check_kernel(torch, fa, shape, torch.float32, gen)
                    if shape in ODD_SHAPES else None)
        check_seconds += time.perf_counter() - t1
        B, Nq, Nk, H, D = shape
        q = torch.randn((B, Nq, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((B, Nk, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 10 if Nq >= 1024 else 50
        row = {
            "shape": list(shape), "launches": by_shape.get(shape, 0),
            "launches_512x768": k1_768.get(shape, 0), "launches_cfg": cfg_k1.get(shape, 0),
            "launches_segments": seg_k1.get(shape, 0),
            "launches_ip_adapter_512x768": ip_k1.get(shape, 0),
            "launches_variants": var_k1.get(shape, 0),
            "max_abs_err_bf16": err_bf16, "max_abs_err_fp32": err_fp32,
            "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v), iters),
            "plain_ms": None if shape in untimed_k1 else cuda_ms(
                torch, lambda: fa.flash_attention_plain(q, k, v), PLAIN_ITERS, warmup=0),
            "library_ms": cuda_ms(torch, lambda: sdpa(qt, kt, vt), iters),
        }
        row["ops_ms"], row["bytes_ms"] = attention_bound_ms(shape, 2)
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        row["tflops"] = 4.0 * B * H * Nq * Nk * D / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(json.dumps({"k1": row}), flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    by_row = {tuple(r["shape"]): r for r in rows}
    # K1 at the depth annotators' shapes (the DPTs' and GLPN's at b4 and
    # 512x768, GLPN's at 512x512 in the disk phase's CLI run), and at the
    # reference's b0 GLPN shapes (D = 32), checked in fp32, their dtype
    # (their path: the controlnet phase's timed calls of the three networks,
    # the CLI run; bf16 at D = 64 and 32 is checked in tests/test_torch_gpu.py);
    # and, but at the CLI run's and the b0 GLPN's shapes (B = 1 there,
    # launch-bound), timed: K1, SDPA and the plain version, beside the bound
    depth_rows = []
    untimed_depth = sorted(set(depth_cli_k1) - set(depth_k1)) + sorted(glpn_ref_k1)
    for shape in sorted(depth_k1) + untimed_depth:
        t1 = time.perf_counter()
        row = {"shape": list(shape), "launches_annotators_512x768": depth_k1.get(shape, 0),
               "launches_cli": depth_cli_k1.get(shape, 0),
               "launches_reference": glpn_ref_k1.get(shape, 0),
               "max_abs_err_float32": check_kernel(torch, fa, shape, torch.float32, gen)}
        check_seconds += time.perf_counter() - t1
        if shape not in untimed_depth:
            B, Nq, Nk, H, D = shape
            q, k, v = (torch.randn((B, n, H, D), generator=gen, device="cuda")
                       for n in (Nq, Nk, Nk))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["ms_float32"] = cuda_ms(torch, lambda: fa.flash_attention(q, k, v), 20)
            row["library_ms_float32"] = cuda_ms(torch, lambda: sdpa(qt, kt, vt), 20)
            ops, nbytes = attention_bound_ms(shape, 4)
            row["bound_ms_float32"] = max(ops, nbytes)
            row["bound_by_float32"] = "operations" if ops >= nbytes else "bytes"
            row["plain_ms_float32"] = cuda_ms(
                torch, lambda: fa.flash_attention_plain(q, k, v), PLAIN_ITERS, warmup=0)
            del q, k, v, qt, kt, vt
        depth_rows.append(row)
        print(json.dumps({"k1_depth": row}), flush=True)
        torch.cuda.empty_cache()
    def depth_sums(shapes):
        """The fp32 times summed over the annotators step's launches of
        `shapes`."""
        return {"launches": sum(depth_k1[k] for k in shapes), **{
            key: sum(r[key] * r["launches_annotators_512x768"] for r in depth_rows
                     if tuple(r["shape"]) in shapes)
            for key in ("ms_float32", "plain_ms_float32", "library_ms_float32",
                        "bound_ms_float32")}}

    depth_path = depth_sums(set(depth_k1) - set(glpn_768_k1))
    glpn_path = depth_sums(set(glpn_768_k1))

    def window_sums(full, overlapped, lat=(size // 8, size // 8),
                    keys=("ms", "plain_ms", "library_ms", "bound_ms")):
        """K1's per-launch times summed over one window's launches."""
        weights = expected_k1_launches(full, overlapped, steps, frames_n, overlap, latent=lat)
        return {key: sum(n * by_row[shape][key] for shape, n in weights.items())
                for key in keys}

    def launched_sums(launches, keys=("ms", "plain_ms", "library_ms", "bound_ms")):
        """K1's per-launch times summed over one run's launches by shape."""
        return {key: sum(n * by_row[shape][key] for shape, n in launches.items())
                for key in keys}

    phase("kernels", t0, shapes=len(rows), check_seconds=round(check_seconds, 3),
          per_full_window=window_sums(1, 0),
          vid2vid_path={"launches": sum(v2v_counts["k1_by_shape"].values()),
                        **launched_sums(v2v_counts["k1_by_shape"])},
          controlnet_path={"launches": sum(cn_k1.values()), **launched_sums(cn_k1)},
          cfg_path={"launches": sum(cfg_k1.values()), **launched_sums(cfg_k1, UNTIMED_PLAIN)},
          segments_path={"launches": sum(seg_k1.values()),
                         **launched_sums(seg_k1, UNTIMED_PLAIN)},
          variants_path={"launches": sum(var_k1.values()),
                         **launched_sums(var_k1, UNTIMED_PLAIN)},
          grid_shapes={str(k): {key: by_row[k][key] for key in (
              "ms", "library_ms", "bound_ms", "max_abs_err_bf16")} for k in K1_GRID_SHAPES},
          ip_adapter_512x768_path={"launches": sum(ip_k1.values()),
                                   **launched_sums(ip_k1, UNTIMED_PLAIN)},
          image_encoder={"launches": ip_k1.get(VISION_K1_SHAPE, 0),
                         **{k: by_row[VISION_K1_SHAPE][k] for k in (
                             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                             "max_abs_err_bf16", "tflops", "share_of_bound")}},
          depth_path=depth_path, glpn_path=glpn_path,
          per_overlap_window=window_sums(0, 1),
          per_full_window_512x768=window_sums(1, 0, latent, UNTIMED_PLAIN),
          per_overlap_window_512x768=window_sums(0, 1, latent, UNTIMED_PLAIN))

    # -- K2 at every shape the vid2vid phase launched it with -------------
    t0 = time.perf_counter()
    k2_by_shape = v2v_counts["k2_by_shape"]
    k2_rows = []
    k2_launched = {**k2_by_shape, **k2_768}
    check_seconds = 0.0
    # fp32 K2 runs only in the reference phase, at 64x64: it is checked at
    # the odd shapes, the main path's (bf16) in bf16 alone
    for shape in sorted({key[:5] for key in k2_launched}) + K2_ODD_SHAPES:
        t1 = time.perf_counter()
        err_bf16 = check_k2(torch, ck, shape, torch.bfloat16, gen)
        err_fp32 = check_k2(torch, ck, shape, torch.float32, gen) if shape in K2_ODD_SHAPES else None
        check_seconds += time.perf_counter() - t1
        x, w, bias, affine, res = k2_inputs(torch, shape, torch.bfloat16, gen)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        variants = sorted({key[5:] for key in k2_launched if key[:5] == shape}) or [(True, True)]
        B, H, W, Cin, Cout = shape
        iters = 3 if 2 * 9 * B * H * W * Cin * Cout > 2e11 else 10
        for has_affine, has_res in variants:
            kw = {"affine": affine, "act": "silu"} if has_affine else {}
            if has_res:
                kw["residual"] = res
            z = ck.activate(x, kw.get("affine"), kw.get("act")).permute(0, 3, 1, 2)
            row = {
                "shape": list(shape), "affine_silu": has_affine, "residual": has_res,
                "launches": k2_by_shape.get(shape + (has_affine, has_res), 0),
                "launches_512x768": k2_768.get(shape + (has_affine, has_res), 0),
                "max_abs_err_bf16": err_bf16, "max_abs_err_fp32": err_fp32,
                "ms": cuda_ms(torch, lambda: ck.conv3x3_fused(x, w, bias, **kw), iters),
                # the plain version is timed at the main path's shapes only
                "plain_ms": None if shape + (has_affine, has_res) not in k2_by_shape else cuda_ms(
                    torch, lambda: ck.conv3x3_fused_plain(x, w, bias, **kw), PLAIN_ITERS,
                    warmup=0),
                "library_ms": cuda_ms(
                    torch, lambda: torch.nn.functional.conv2d(z, w_oihw, bias.to(z.dtype),
                                                              padding=1), iters),
            }
            row["ops_ms"], row["bytes_ms"] = conv_bound_ms(shape, 2, has_res)
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
            row["tflops"] = 2.0 * 9 * B * H * W * Cin * Cout / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            k2_rows.append(row)
            print(json.dumps({"k2": row}), flush=True)
            del z
        del x, w, w_oihw, bias, affine, res
        torch.cuda.empty_cache()
    k2_by_row = {tuple(r["shape"]) + (r["affine_silu"], r["residual"]): r for r in k2_rows}

    def k2_window_sums(full, overlapped, hw=(size, size),
                       keys=("ms", "plain_ms", "library_ms", "bound_ms")):
        """K2's per-launch times summed over one window's launches."""
        weights = expected_k2_launches(models.vae, hw, frames_n, overlap, full, overlapped)
        return {key: sum(n * k2_by_row[k][key] for k, n in weights.items()) for key in keys}

    # the GroupNorm fold before K2, at the largest input the path folds
    B, H, W, Cin = max((key[:4] for key in k2_by_shape if key[5]), key=math.prod)
    x = torch.randn((B, H, W, Cin), generator=gen, device="cuda").bfloat16()
    ones, zeros = torch.ones(Cin, device="cuda"), torch.zeros(Cin, device="cuda")
    print(json.dumps({"k2_fold": {
        "shape": [B, H, W, Cin],
        "fold": fold_cost(torch, lambda t: ck.groupnorm_fold(t, ones, zeros, 32, 1e-6), x),
        "fp32_copies": fold_cost(torch, fold_with_fp32_copies, x)}}), flush=True)
    del x
    torch.cuda.empty_cache()
    phase("kernels_k2", t0, shapes=len(k2_rows), check_seconds=round(check_seconds, 3),
          per_full_window=k2_window_sums(1, 0),
          per_overlap_window=k2_window_sums(0, 1),
          per_full_window_512x768=k2_window_sums(1, 0, (height_768, size), UNTIMED_PLAIN))

    # -- K3 at every shape the window_motion_kernel phase launched it with --
    t0 = time.perf_counter()
    k3_rows = []
    # the main path's shapes, the segment run's (v1, B = 4), the odd ones
    k3_shapes = [key + (True,) for key in sorted(set(k3_by_shape) | set(seg_k3))] + K3_ODD_SHAPES
    for shape in k3_shapes:
        # fp32 K3 runs in the reference phase alone: the segment run's own
        # shapes (B = 4) are checked in bf16
        errs = check_k3(torch, mk, shape, gen,
                        fp32=shape[:5] in k3_by_shape or shape[:5] not in seg_k3)
        torch.cuda.empty_cache()
        mod, x = k3_inputs(torch, shape, gen)
        mod, x = mod.to(torch.bfloat16), x.bfloat16()
        p, pe = mod.fused_operands(x)
        heads = shape[4]
        packed = mk.pack_weights(p, x.dtype)
        iters = 5 if math.prod(shape[:4]) >= 16 * 1024 * 320 else 20
        # the plain version is timed at the main path's and the odd shapes
        timed_plain = shape[:5] in k3_by_shape or shape[:5] not in seg_k3
        with torch.no_grad():
            row = {
                "shape": list(shape), "launches": k3_by_shape.get(shape[:5], 0),
                "launches_segments": seg_k3.get(shape[:5], 0), **errs,
                "ms": cuda_ms(torch, lambda: mk.motion_module_fused(
                    x, p, heads=heads, pe=pe, packed=packed), iters),
                "plain_ms": cuda_ms(torch, lambda: mk.motion_module_plain(
                    x, p, heads=heads, pe=pe), iters) if timed_plain else None,
                "library_ms": cuda_ms(torch, lambda: mod(x), iters),
            }
        row["ops_ms"], row["bytes_ms"] = motion_bound_ms(shape, 2)
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        if row["launches"]:
            split = k3_stage_split(torch, mk, shape, x, p, pe, packed)
            row["chain_bytes_ms"] = split["chain_bytes_ms"]
            print(json.dumps({"k3_stages": split}), flush=True)
            with torch.no_grad():
                row["device_ms"] = device_busy_ms(torch, lambda: mk.motion_module_fused(
                    x, p, heads=heads, pe=pe, packed=packed))
                row["library_device_ms"] = device_busy_ms(torch, lambda: mod(x))
        k3_rows.append(row)
        print(json.dumps({"k3": row}), flush=True)
        del mod, x, p, pe, packed
        torch.cuda.empty_cache()
    k3_by_row = {tuple(r["shape"][:5]): r for r in k3_rows if r["shape"][5]}
    per_window = {key: sum(n * k3_by_row[k][key] for k, n in k3_by_shape.items()) / WINDOWS
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms", "chain_bytes_ms",
                              "device_ms", "library_device_ms")}
    segments_path = {key: sum(n * k3_by_row[k][key] for k, n in seg_k3.items())
                     for key in ("ms", "library_ms", "bound_ms")}
    phase("kernels_k3", t0, shapes=len(k3_rows), per_window=per_window,
          segments_path={"launches": sum(seg_k3.values()), **segments_path})

    # -- K4 at every shape the vid2vid_upscale phase launched it with ------
    t0 = time.perf_counter()
    F = torch.nn.functional
    k4_rows = []
    launched = sorted(k4_by_shape)
    launched_768 = sorted(set(k4_768) - set(k4_by_shape))
    odd = [shape + (up,) for shape in K4_ODD_SHAPES for up in (True, False)]
    for key in launched + launched_768 + odd:
        shape, upsample = key[:5], key[5]
        # bf16 as launched; at the 512x768 run's shapes the plain version
        # runs a frame at a time (its fp32 copies of 8 frames at 3072x2048
        # would hold about 40 GB)
        err_bf16 = check_k4(torch, uk, shape, upsample, torch.bfloat16, gen,
                            by_frame=key in launched_768)
        torch.cuda.empty_cache()
        # fp32 (the reference phase's dtype, which runs it at 64x64) at the
        # odd shapes, at batch 1
        err_fp32 = (check_k4(torch, uk, (1,) + shape[1:], upsample, torch.float32, gen)
                    if key in odd else None)
        torch.cuda.empty_cache()
        x, w, bias = k4_inputs(torch, shape, torch.bfloat16, gen)
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        w_oihw = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)

        def library():
            h = F.interpolate(xc, scale_factor=2.0, mode="nearest") if upsample else xc
            return F.leaky_relu(F.conv2d(h, w_oihw, b16, padding=1), 0.2)

        B, H, W = shape[:3]
        iters = 3 if B * H * W >= 4 * 1024 * 1024 else 10
        packed = uk.kernel_weights(w, x.dtype, upsample)  # folded once, as the upscaler does
        row = {
            "shape": list(shape), "upsample": upsample, "launches": k4_by_shape.get(key, 0),
            "launches_512x768": k4_768.get(key, 0),
            "max_abs_err_bf16": err_bf16, "max_abs_err_fp32": err_fp32,
            "ms": cuda_ms(torch, lambda: uk.upconv3x3(x, w, bias, upsample=upsample,
                                                      act="lrelu", packed=packed), 10),
            "unpacked_ms": cuda_ms(torch, lambda: uk.upconv3x3(x, w, bias, upsample=upsample,
                                                               act="lrelu"), 10),
            # the plain version is timed on the main path's shapes only
            "plain_ms": None if key not in k4_by_shape else cuda_ms(
                torch, lambda: uk.upconv3x3_plain(x, w, bias, upsample=upsample, act="lrelu"),
                iters),
            "library_ms": cuda_ms(torch, library, iters),
        }
        row["ops_ms"], row["bytes_ms"], row["folded_gflop"] = upconv_bound_ms(shape, upsample, 2)
        row["useful_gflop"] = row["ops_ms"] * PEAK_BF16_FLOPS / 1e12
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        row["tflops"] = row["useful_gflop"] / row["ms"]
        row["gbs"] = row["bytes_ms"] * PEAK_BYTES / 1e9 / row["ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if key in k4_by_shape or key in k4_768:
            row["plan"] = uk.kernel_plan(*shape, upsample)
        k4_rows.append(row)
        print(json.dumps({"k4": row}), flush=True)
        del x, w, bias, xc, w_oihw, b16, packed
        torch.cuda.empty_cache()
    k4_by_row = {tuple(r["shape"]) + (r["upsample"],): r for r in k4_rows}
    per_frame = {k: sum(n * k4_by_row[key][k] for key, n in k4_by_shape.items()) / up_n
                 for k in ("ms", "unpacked_ms", "plain_ms", "library_ms", "bound_ms",
                           "folded_gflop", "useful_gflop")}
    per_frame_768 = {k: sum(n * k4_by_row[key][k] for key, n in k4_768.items()) / frames_n
                     for k in ("ms", "unpacked_ms", "library_ms", "bound_ms", "useful_gflop")}
    phase("kernels_k4", t0, shapes=len(k4_rows), per_frame=per_frame,
          per_frame_512x768=per_frame_768)

    def path_sum(by_row, by_shape, key):
        """`key` summed over one path's launches (launches x per-launch value
        at each shape)."""
        return sum(by_row[shape][key] * n for shape, n in by_shape.items())

    def kernel_entry(name, source, replaces, by_row, by_shape, errs):
        ops, nbytes = (path_sum(by_row, by_shape, k) for k in ("ops_ms", "bytes_ms"))
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_shape.values()),
            "max_abs_err": max(errs),
            "ms": path_sum(by_row, by_shape, "ms"),
            "plain_ms": path_sum(by_row, by_shape, "plain_ms"),
            "bound_ms": path_sum(by_row, by_shape, "bound_ms"),
            "bound_by": "operations" if ops >= nbytes else "bytes",
            "library_ms": path_sum(by_row, by_shape, "library_ms"),
        }

    # launches and sums over the main path: the vid2vid phase's run
    kernels = [
        kernel_entry("flash_attention", "controlanimate_tpu_torch/csrc/flash_attention.cu",
                     "controlanimate_tpu/ops/flash_attention.py:40", by_row,
                     v2v_counts["k1_by_shape"], [r["max_abs_err_bf16"] for r in rows]),
        kernel_entry("conv3x3_fused", "controlanimate_tpu_torch/csrc/conv3x3_fused.cu",
                     "controlanimate_tpu/ops/conv_kernel.py:79", k2_by_row,
                     k2_by_shape, [r["max_abs_err_bf16"] for r in k2_rows]),
        # K3's path is the window_motion_kernel phase's run
        kernel_entry("motion_module_fused", "controlanimate_tpu_torch/csrc/motion_module.cu",
                     "controlanimate_tpu/ops/motion_kernel.py:94", k3_by_row, k3_by_shape,
                     [r["max_abs_err_bf16"] for r in k3_rows]),
        # K4's path is the vid2vid_upscale phase's run
        kernel_entry("upconv3x3", "controlanimate_tpu_torch/csrc/upconv3x3.cu",
                     "controlanimate_tpu/ops/upconv_kernel.py:67", k4_by_row, k4_by_shape,
                     [r["max_abs_err_bf16"] for r in k4_rows]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"total_seconds": round(time.perf_counter() - t_all, 3)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
