#!/usr/bin/env python3
"""Chip smoke test of icl_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi), torch's device name;
  2. the builds of the window-attention CUDA kernels (forward and
     backward, each up to head dim 64, a library of its own above it in
     64-column chunks, and one streaming the chunks at every head dim) and
     of the SR kernel from ops/csrc, one nvcc each, and of
     the host's C++ order-0 zoom and rotate (`icl_tpu_torch/native`, the
     host's g++; required), started together; the host library's seconds
     and the host CPU; each
     kernel instance's registers and spills from the ptxas log, and each
     kernel's warps, shared memory and resident CTAs per SM at the paths'
     window sizes, as the kernel reports them, and their refusal of a
     window that cannot fit;
  3. the forward kernel against its plain PyTorch version at the four
     shapes of one SwinUNETR fs48 sw_batch-4 forward at 96^3, f32 and
     bf16, and bitwise equal across two runs;
  4. times at those shapes: the kernel, the plain version, and
     F.scaled_dot_product_attention as the one PyTorch call that computes
     the same function, beside the kernel's bound and its time before its
     tensor-core redesign (a constant from PERF.md);
  5. BraTS sliding-window inference with SwinUNETR fs48 (1 channel, 2
     classes, seeded init) on a seeded 160x160x128 volume, 96^3 patches,
     stride 64, sw_batch 4: 8 patches in 2 forwards; the kernel launches
     are counted and must be 16 (5 no-mask + 3 region per forward);
  6. one sw_batch forward's probabilities against the same weights with
     the plain attention;
  7. the backward kernel against its plain version at the four attention
     shapes of one SwinUNETR-ICL training pass (batch 2 at 96^3), in both
     mask modes where the stage shifts, f32 and bf16, and bitwise equal
     across two runs;
  8. times at those shapes: the backward kernel, the plain backward, and
     the backward of F.scaled_dot_product_attention (q, k, v and the mask),
     beside the bound and the kernel's time before its tensor-core
     redesign (a constant from PERF.md);
  9. SwinUNETR-ICL training: fs48 at 96^3, batch 4 (2 labeled), f32 with
     TF32 off, recompute on, through Trainer.fit for 3 steps on seeded
     in-memory 128^3 cases, with a validation at step 3 on one held-out
     case; s/step after the warm-up step, peak memory, every loss term,
     and the kernel launches per step (asserted: 16 backward, 10 no-mask +
     6 region; 32 forward, the 16 of the two passes and their recompute);
     then one step under bfloat16 autocast;
 10. one training step through the kernels against the same step with the
     plain attention (same weights and batch, f32, drop path off): every
     loss term, and the updated bias tables and qkv weights of stages 1
     and 4; then, from the same state, the step with the fused sspa pair
     against the two-call step over every parameter, by the same rule, the
     fused step on the batch times 1 + 1e-7 as the control, and as the
     witness, as in 42, per tensor the farthest of the two-call step on the
     batch times 1 - 1e-7 and on each branch's rows reversed;
 11. train -> eval: the stripped best checkpoint loads strictly through
     the eval CLI's loader and gives the trainer's validation dice;
 12. the dense-mask (MASK) and no-mask forward kernels at head dim 32
     against their plain versions at the attention shapes of one
     Swin-UNet 2D backbone pass at 384^2, window 12, batch 8, at the
     reference's 224^2 / window-7 stage 1 and at a 2 x 2 window, with the
     shift mask and a random dense mask, f32 and bf16, bitwise equal
     across two runs; f32 times beside the bound, the plain version, SDPA
     and the time before the redesign;
 13. the backward kernel in both modes at head dim 32 at the same shapes,
     both masks, f32 and bf16, bitwise equal across two runs;
     f32 times beside the bound, the plain backward, SDPA's backward and
     the time before the redesign;
 14. Swin-UNet-ICL training on ACDC, the main path of this slice: embed
     96, depths 2-2-2-2, heads 3-6-12-24, 384^2, window 12, 4 classes,
     batch 16 (8 labeled), consistency weight 50, f32 with TF32 off, no
     recompute, through Trainer.fit for 3 steps on seeded in-memory
     256^2 slices, with a validation at step 3 on two seeded volumes;
     s/step after the warm-up step, the host's batch time (the same 3
     batches made through the C++ helper and through scipy, the arrays
     equal and the helper's calls some, asserted), the validation
     time, peak memory, every loss term, and the kernel launches (asserted
     per step: 28 forward and 28 backward, each 16 no-mask + 12 mask; per
     validation chunk 14 forward, 8 + 6);
 15. one 2D training step through the kernels against the same step with
     the plain attention, beside a control step, and the fused sspa pair
     against the two calls, as in 10;
 16. 2D train -> eval: the stripped best checkpoint loads strictly
     through the 2D eval CLI's loader and gives the trainer's validation
     dice;
 17. U-Net-ICL training on ACDC, the main path of this slice and the JAX
     package's default model: U-Net features (16, 32, 64, 128, 256),
     dropout (0.05, 0.1, 0.2, 0.3, 0.5), ICL heads on (128, 64, 32)
     channels, heads (8, 4, 2), resolutions (32, 64, 128) (`mlp2` 16384^2
     at the finest), 256^2, 4 classes, batch 16 (8 labeled), consistency
     weight 50, f32 with TF32 off, through Trainer.fit for 3 steps on
     phase 14's slices made on a `Prefetcher` thread, with a validation
     at step 3 on its two volumes; s/step after the warm-up step, the
     step thread's wait for each batch, the host's batch time native
     against scipy as in 14, the validation time, the time to
     build the model, peak memory, every loss term, and the
     window-attention launches (asserted: none);
 18. one U-Net-ICL step at 64^2 on the card against the same step on the
     CPU (same weights and batch, dropout and drop path off), beside a
     control step, the rule of 10 over every parameter;
 19. one full-width U-Net-ICL step with the two `sspa` calls fused
     against the two-call step on the card, in f64, the rule of 10;
 20. U-Net train -> eval: the stripped best checkpoint loads strictly into
     UNet through the 2D eval CLI's loader and gives the trainer's
     validation dice;
 21. U-Net-ICL 3D training on BraTS, the main path of this slice, at the
     JAX 3D U-Net CLI's defaults: filters (16, 32, 64, 128, 256), ICL heads
     on (256, 128, 64) channels, heads (16, 8, 4), resolutions (6, 12, 24)
     (`mlp2` 13824^2 at the finest), 96^3, batch 4 (2 labeled), 2 classes,
     consistency weight 10, f32 with TF32 off, through Trainer.fit for 3
     steps on phase 9's 128^3 cases made on a `Prefetcher` thread, with a
     validation at step 3 on the held-out case; s/step after the warm-up
     step, the step thread's wait for each batch, the validation time, the
     time to build the model, its parameters, peak memory, every loss
     term, the window-attention launches (asserted: none); then one step
     under bfloat16 autocast (`Trainer.train_step`);
 22. one U-Net-ICL 3D step at 32^3 on the card against the same step on
     the CPU (same weights and batch, dropout and drop path off), beside a
     control step, the rule of 18;
 23. two steps of the supervised U-Net 3D on the BraTS cases through
     Trainer.fit (no window attention, asserted);
 24. U-Net 3D train -> eval: the stripped best checkpoint of 21 loads
     strictly into UNet3D through test_3D_BraTS's loader (`--model
     unet_3D_icl`) and gives the trainer's validation dice;
 25. AMOS22 through the JAX AMOS CLI's own defaults (`main` of the port's
     CLI): a seeded synthetic NIfTI tree (4 training cases and 1
     validation case of (96, 96, 72) voxels at spacing (2, 2, 3)),
     U-Net-ICL 3D, 16 classes, bf16 autocast, recompute on, 3 steps and a
     validation by `evaluate_amos_cases`; s/step, peak memory, every loss
     term, the validation time, the window-attention launches (none);
 26. the supervised AMOS CLI for 2 steps (loss 0.5 (CE + Dice));
 27. AMOS train -> eval: test_3D_AMOS on the stripped best checkpoint of
     25 gives the trainer's validation dice;
 28. both kernels at the shapes of the fully supervised Swin paths,
     against their plain versions and bitwise repeatable, timed beside
     the bound, the plain version and SDPA: Swin-UNet at 224^2 / window
     7, batch 16, f32, stages 1-4 (N = 49; with the shift mask and
     without); SwinUNETR at batch 4 in bf16, stages 1-4 (stage 1
     [1372, 3, 343, 16]; with region ids and without);
 29. the supervised 2D U-Net CLI's `main` at its defaults (256^2, batch
     16, f32) on phase 14's slices and volumes in memory, 3 steps and a
     validation, no window attention (asserted); `test_2D_ACDC.main
     --model unet` on its best checkpoint gives the validation dice;
 30. the supervised Swin-UNet CLI's `main` at its defaults (224^2,
     window 7, batch 16, f32) from a synthetic ImageNet-layout Swin-T
     checkpoint (a seeded model's encoder, a head, one key of the wrong
     shape, which is dropped with its decoder mirror), 3 steps and a
     validation, the launches per step asserted (8 no-mask + 6 mask,
     forward and backward; per validation chunk 8 + 6 forward); one step
     through the kernels against the plain attention by the rule of 15;
     `test_2D_ACDC.main --model swinunet` gives the validation dice;
 31. the supervised SwinUNETR CLI's `main` at its defaults (fs48, 96^3,
     batch 4, bf16, recompute on) from a synthetic SSL SwinViT checkpoint
     in the reference layout (every encoder parameter loaded), 3 steps
     and a validation on phase 9's cases, the launches per step asserted
     (forward 10 no-mask + 6 region with the recompute, backward 5 + 3);
     `test_3D_BraTS.main --model swinunetr` gives the validation dice;
 32. resume on U-Net-ICL 2D at full width: 4 steps against 2, a save, a
     fresh Trainer's `restore_state` (equal to the saved state bit for
     bit: parameters, buffers, momentum, count, iteration, RNG states)
     and 2 more on the same batches, under cuDNN's deterministic
     algorithms: bit for bit (a repeat of the 4 steps runs only to say
     which is at fault where they differ); the seconds of the save and the
     restore;
 33. FixMatch-CTA through its CLI's `main` at the JAX CLI's defaults (the
     U-Net, 256^2, batch 16 of which 8 labeled, 4 classes, threshold 0.95,
     unsupervised weight 1, f32 with TF32 off) on phase 14's slices in
     memory, the first 16 labeled: 4 steps with --checkpoint_interval 2
     --cta_rate_lag 1, then 2 steps with --cta_rate_lag 0 under an --exp
     of their own; s/step after the warm-up step, peak memory, every loss
     term, the mask ratio and probe proximity per step, the rate bins that
     moved (asserted: some), the window-attention launches (asserted:
     none); the host seconds of one cta_batches batch made alone (the CLI
     makes its batches inline), native against scipy as in 14, split into
     CTAugment's ops, the zooms and the rest, from phase 14's slices and
     from their first 216 columns (256 x 216, an ACDC size); and of the step
     alone;
 34. one FixMatch-CTA step at 64^2 on the card against the same step on
     the CPU (same weights and batch, dropout off, the threshold in a gap
     of the confidences near their median, so that the mask is neither
     empty nor full and the same on all, asserted): in f64 by the rule
     of 18 beside a control step; in f32 against the CPU's f64 step,
     with the CPU's own f32 step as the witness of f32 rounding; the fused
     probe proximity against a separate probe forward on the card;
 35. resume: a fresh CTATrainer restores 33's rate-lag-1 save at step 4
     (state_last, bit for bit; cta_state.json, the rates equal), then the
     CLI's --resume takes steps 5 and 6, saves step_00000006 and ends
     with state_last;
 36. the bf16 stochastic-rounding SGD kernel (built in phase 2 beside the
     window-attention kernels) against its plain version, bit for bit,
     and bitwise across two runs, at the flagship's largest leaf (`mlp2`,
     16384^2), a small leaf, a ragged length and an unaligned address;
     over the flagship's 300 leaves (1.15 B parameters): its time per call
     and on the device alone beside the 3.4 ms bound, the plain version,
     torch.optim.SGD(fused=True) on the same bf16 tensors and the f32
     PolySGD step on an f32 state; its largest leaf alone beside its
     bound, plain version and fused SGD; the card's kernel tests, both
     files in one pytest without tests/conftest.py, run beside phase 39;
 37. the flagship's fast configuration through its CLI's `main` (bf16
     autocast, a bf16 train state, the fused sspa pair, the device bank,
     groups of 4 graph replays, 2 in flight) on phase 14's slices in
     memory: 8 steps, a validation at 8, a checkpoint every 4; peak
     memory, the state's bytes, every loss term, the SR launches (asserted:
     300 for the eager first step and 300 recorded by the capture, which
     every one of the 7 replays runs), no window attention (asserted);
 38. graph replay against eager steps from one state (cuDNN's deterministic
     algorithms): the flagship's fast configuration, the supervised
     Swin-UNet (224^2, window 7, batch 16, f32; the launches of the graph's
     first step asserted: 8 no-mask + 6 mask, forward and backward, for the
     eager step and again for the capture), 4 replays against 4 eager
     steps bit for bit (parameters, buffers, momentum, metrics), an eager
     repeat beside them; the AMOS bf16 ICL step (U-Net-ICL 3D, 16 classes,
     recompute on) the same way, its eager repeat and its replays bitwise
     (asserted; autocast's weight cache off in every step); s/step eager
     and replayed for the three; whether the backward of F.interpolate's
     bilinear upsample repeats bitwise on the card (the port's linear
     resizes are matmuls for that reason);
 39. under cuDNN's deterministic algorithms, `fit` of the supervised
     Swin-UNet in groups of 2 at dispatch_depth 2 against 1 (parameters bit
     for bit, log.txt's loss lines equal), and the bf16 train state resumed
     from a step-4 save, 4 + 4 steps against 8 bit for bit, on the
     supervised Swin-UNet and on the flagship's fast configuration;
 40. the device augment (`augment_batch`) on the card against the CPU for
     every angle in [-20, 20), every rot90/flip branch and the identity, at
     256^2 and zoomed to 224^2: 0 differing pixels; one flagship batch's
     time;
 41. the 3D repeats: the 3D U-Net's upsample (matmuls) against
     F.interpolate's trilinear mode in f32; one BraTS f32 U-Net-ICL 3D
     step twice from one state under cuDNN's deterministic algorithms: 0
     tensors differ (asserted; the AMOS bf16 ICL step's eager repeat is
     phase 38's); the ops that torch.use_deterministic_algorithms names on
     the BraTS step;
 42. the flagship as 2 ranks on the one card (gloo; each rank a process of
     this script, `--dp-worker`): its CLI's `main` at its defaults (256^2,
     batch 16 of which 8 labeled, f32, dropout on) through
     --dist_coordinator on phase 14's data, 1 step and a validation: the
     ranks' final states bitwise equal, only rank 0 wrote, test_2D_ACDC on
     its best checkpoint gives the validation dice; each step's compute and
     all-reduce seconds and the peak memory per rank; then `Trainer` at
     full width with zero_stochastic, 2 f32 steps over 2 ranks against 1
     process on the same global batches by phase 18's rule over every
     parameter, buffer and momentum, cuDNN deterministic (control: the
     images times 1 + 1e-7; witness: per tensor the farthest of four
     one-process runs of the same steps in other f32 arithmetic: the
     images times 1 - 1e-7, reversed rows, the data-parallel BatchNorm
     formula, both), the first step's loss terms within 1e-5, and 1 step with a bf16
     state: the replicas bitwise equal (f32 and bf16), the SR kernel's
     launches counted per rank;
 43. NCCL at world size 1 on the card: all_reduce_sum forward and backward,
     reduce_gradients, all_gather_case_metrics, each equal to its input;
     phase 5's sliding window through make_fused_sliding_window(group=...)
     over 2 gloo ranks on the card: the label map equals the one-process
     map but at near-ties within 1e-6 (counted), the window-attention
     launches per rank counted (asserted: 8 forwards' worth in all);
 44. gradient accumulation (k = 2) on the flagship at full width (U-Net-ICL
     2D, 256^2, batch 16 of which 8 labeled, f32, zero_stochastic, cuDNN
     deterministic): 4 micro-steps on one repeated batch against 2 k = 1
     updates, the first of them counted for FLOPs (parameters and momentum
     bit for bit, nothing moved inside a window); 4 replays of the two
     captured graphs (accumulate; accumulate and update) against 4 eager
     micro-steps from one state (every tensor and the metrics bit for
     bit); s/step of k = 2 and k = 1, eager and replayed, in turns; `fit`
     for 4 steps in a group of 4 replays with a validation: its loss lines,
     its logged LRs (each its update's), its FLOP lines, its peak memory;
 45. FixMatch-CTA with the Swin-UNet through its CLI's `main` (`--model
     swinunet --patch_size 224 224`: embed 96, window 7, batch 16 of which
     8 labeled, f32) for 3 steps, the window-attention launches asserted
     (per step 42 forward, the weak, strong and probe passes' 8 no-mask + 6
     mask each, and 28 backward), a validation of its final weights; one
     step through the kernels against the plain attention by the rule of
     15; one f32 step on the card (embed 48) against the CPU's f64 step,
     the CPU's f32 step the witness (the rule of 34); one step traced with
     `utils.profiling.trace`, whose Chrome trace must name the forward and
     backward kernels at their launch counts: the device's ms and the
     kernels' ms per call; the step's analytic FLOPs and time;
 46. the analytic FLOP lines of every `Trainer.fit` of the run: GFLOP per
     step (its first step counted, `utils/flops.py`) and end-to-end TFLOP/s,
     both lines in each run's log.txt (asserted);
 47. tensor parallelism (`parallel/mesh.py`, `parallel/tensor.py`), every
     rank a process of this script on the one card over gloo: the rule
     table at M = 2 for the flagship at 256^2 and SwinUNETR-ICL fs48, every
     sharded leaf's whole and local shape, the layers left replicated (3
     heads), each rank's parameter bytes;
 48. the flagship (U-Net-ICL 2D, 256^2, batch 16 of which 8 labeled, f32,
     zero_stochastic, cuDNN deterministic) over tp=2, run by phase 42's
     two ranks after their data-parallel steps: the same 2 steps twice from
     one state (bitwise equal: the eager repeat), the replicated leaves
     bitwise equal across the ranks, s/step, collective calls and bytes a
     step and peak memory per rank; then against phase 42's one-process
     runs by phase 18's rule over every gathered parameter, buffer and
     momentum (the same control and witness), the first step's loss terms
     within 1e-5;
 49. SwinUNETR-ICL fs48 at 96^3 over tp=2 (phase 9's configuration; batch
     2 if two ranks' peaks of phase 9 would not fit the card): both kernels
     at the local shapes (stage 1's 3 heads whole, stages 2-4 on 3, 6 and
     12 heads) against their plain versions, f32 and bf16, bitwise
     repeatable; the launches of one step by their heads, reckoned from
     the heads; one step against one process by phase 18's rule (the
     control the tp=2 step on the images times 1 + 1e-7, the witness the
     one-process step with the row-parallel sums split in two, tp=2's f32
     order); 2 `Trainer` steps, their launches asserted as phase 9's,
     s/step, peak memory, collectives; a validation on the held-out case on
     both ranks and the best model saved, gathered;
 50. train -> eval: the tp=2 run's stripped best checkpoint (gathered,
     the one-process layout) loads strictly into the one-process model,
     whose eval gives the tp=2 validation dice within 1e-4; the flagship
     over dp2 x tp2 (4 ranks) at 256^2 when four tp=2 peaks fit the card,
     else 128^2 (said): one step, the replicated leaves bitwise equal on the
     four ranks and each shard on both data ranks, the first step's loss
     terms against one process within 1e-5, its seconds, collectives, peak
     memory per rank;
 51. the bf16 state over tp=2: the SR kernel on each rank's shard of the
     flagship's `mlp2` fc1 (rows), fc2 (columns), its bias and an `fc_kv`
     weight (two pieces of heads) equals the slice of its whole-leaf update
     bit for bit; a 2-step bf16-state `fit` at 128^2, its SR launches per
     rank asserted (one per contiguous run of every shard);
 52. save and restore at 128^2: a one-process save restored at tp=2 and a
     tp=2 save (the one-process layout) restored at tp=1, each bit for bit
     the saved state;
 53. the host's C++ helper: against scipy.ndimage pixel for pixel (f32
     and u8; every rotation by the 40 integer angles in [-20, 20) and
     every zoom to 256^2, 384^2 and 224^2, at seven ACDC slice sizes), ms
     per call against scipy, and its calls in phases 14, 17 and 33 on a
     `[native]` line; then both kernels at phase 49's tp=2 local shapes,
     f32, timed on the idle card beside the bound, the plain versions and
     SDPA;
 54. both kernels at SwinUNETR fs24's shapes (head dim 8, run at the
     kernels' tile of 16): the four stages of one inference forward
     (stage 1 [1372, 3, 343, 8]) and of one training pass (stage 1
     [686, 3, 343, 8]), no-mask and region ids, f32 and bf16, against their
     plain versions and bitwise repeatable, f32 timed beside the bound, the
     plain version and SDPA; head dims 4 and 12 at the stage-1 shapes,
     held, repeated and timed;
 55. SwinUNETR-ICL at --feature_size 24 through its CLI's `main` on phase
     9's cases (96^3, batch 4 of which 2 labeled, f32 with TF32 off,
     recompute on), 3 steps and a validation, the launches per step
     asserted as phase 9's; test_3D_BraTS --model swinunetr_icl
     --feature_size 24 on its stripped best checkpoint gives the
     validation dice;
 56. the bf16 train state with recompute: one SwinUNETR-ICL step (phase
     9's configuration) with remat against the same step without, from one
     state, cuDNN deterministic, bit for bit, its SR launches (one a leaf)
     and attention launches asserted; 2 replays of the captured step
     against 2 eager steps, bit for bit;
 57. both kernels at head dims 33-64 (the kernels' tile of 64): SwinUNETR
     fs192's shapes (head dim 64 at every stage) of one inference forward
     at sw_batch 4 (stage 1 [1372, 3, 343, 64]) and of one training pass
     (stage 1 [686, 3, 343, 64]), no-mask and region ids, and the
     Swin-UNet 2D stage-1 shapes at head dim 64 ([512, 3, 144, 64] at
     384^2 / window 12, [512, 3, 49, 64] at 224^2 / window 7), no-mask,
     the shift mask and a random dense mask; f32 and bf16, against their
     plain versions and bitwise repeatable (the forward's row log-sum-exp
     against the plain one, its store leaving the output's bits; the
     backward fed the forward kernel's output and row log-sum-exp, as
     WindowAttentionFn saves them, and held against both plain backwards:
     the one recomputing the softmax and window_attention_plain_bwd_lse
     from the same output and log-sum-exp); the forward timed in f32 and
     bf16 beside the bound, the plain version and SDPA in the same type,
     the backward in f32 (the 2D shapes with no mask and the shift mask);
     then head dims 40 and 63 at the 3D stage-1 shapes, held and repeated,
     40 (fs120) timed;
 58. SwinUNETR-ICL at --feature_size 192 (head dim 64 at every stage,
     1.85 B parameters) through its CLI's `main` on phase 9's cases, as
     phase 55: 3 steps and a validation, the launches per step asserted
     as phase 9's, s/step, peak memory and the seconds to build the
     weights; test_3D_BraTS --model swinunetr_icl --feature_size 192 on
     its stripped best checkpoint gives the validation dice;
 59. both kernels at head dims above 64 (the tile-64 kernels in chunks of
     64 columns, a CTA per pair of output chunks): SwinUNETR fs240's shapes
     (head dim 80 at every stage) of one inference forward at sw_batch 4
     and of one training pass (the forward at both), and fs384's stage 1
     (head dim 128), no-mask and region ids, and the Swin-UNet 2D stage-1
     shapes at 3 heads of 128, no-mask, the shift mask and a random dense
     mask; held, repeated and timed as phase 57; then the bf16 forward
     above two chunks (head dims 192, 320, 640) at N 343 and 49, held with
     its log-sum-exp and repeated;
 60. SwinUNETR-ICL at --feature_size 240 (head dim 80 at every stage)
     through its CLI's `main` at the CLI's default precision (bf16
     autocast, recompute on) on phase 9's cases, as phase 58;
 61. the streamed kernels (every head dim and window: `_route` sends a
     call there where the chunked kernels' tiles do not fit a CTA),
     asked for by route: SwinUNETR fs432's stage 1 (head dim 144, three
     64-column chunks) at the inference forward's [1372, 3, 343, 144] and
     the training pass's [686, 3, 343, 144], no mask and region ids; the
     Swin-UNet 2D stage 1 at 192 a head [512, 1, 144, 192], no mask, the
     shift mask and a random mask; head dims 129, 255, 256, 320 and 648
     at N 343 (region ids), 144 (the shift mask) and 49 (a random mask);
     f32 and bf16, the forward with its log-sum-exp and the backward fed
     them, against the plain versions and bitwise repeatable, every launch
     on the streamed route (asserted); f32 timed at fs432 and the 2D shape
     beside the bound, the plain version and SDPA; then SwinUNETR fs48
     with one head a stage (head dims 48, 96, 192, 384: the tile-64,
     chunked and streamed kernels in one model) through phase 5's sliding
     window and one f32 backward pass, launches by route and mode
     asserted, probabilities, loss and gradients against the plain
     attention;
 62. Swin-UNet-ICL 2D at head dim 192 through its CLIs: phase 14's
     configuration with a `--cfg` yaml of EMBED_DIM 192 and NUM_HEADS
     1-2-4-8, 3 steps and a validation through the training CLI's `main`,
     the launches per step asserted as phase 14's and every launch of the
     run on the streamed route; s/step, peak memory, build seconds and
     parameters; one step through the kernels against the plain attention
     by phase 15's rule; test_2D_ACDC --model icl_swinunet --cfg on the
     best checkpoint gives the validation dice;
every `fit` ends with its full train state, which each phase deletes
after its run (in the phases of UNWRITTEN_FINAL_STATES gathered but not
written, a depth cut for the time limit); then a `kernels` JSON line (the six window-attention
entries, the six of the streamed kernels and `sgd_bf16`), the card line, and the result line. Exits
non-zero without a result when CUDA is absent, in a worker too.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

F32_ATOL = 1e-5  # f32 rounding of 343-term sums in another order; 2e-6 seen on an H100
# bf16 inputs, f32 math in both versions, one bf16 rounding of the output:
# at most one bf16 ulp apart, i.e. 2^-7 relative
BF16_ATOL, BF16_RTOL = 1e-3, 1e-2
PROBS_ATOL = 1e-4  # end-to-end probabilities, f32 with TF32 off
# The card's fastest f32-accurate rate, for the bound of both kernels: TF32
# on the tensor cores (H100 SXM, 495 TFLOP/s dense) over the three MMAs of a
# 3xTF32 product, above the 67 TFLOP/s of f32 outside the tensor cores.
F32_ACCURATE_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
# Backward kernel against the plain backward, each grad's max error over
# its reference's largest magnitude. f32: sums of 343 terms in another
# order, __expf, and dbias summing up to 686 windows in another order
# (9.7e-7 seen on an H100). bf16: dq, dk, dv are rounded once to bf16 from
# f32 math in both versions, so within one bf16 ulp (2^-7) of the value;
# dbias stays f32.
BWD_F32_RTOL = 1e-5
BWD_BF16_RTOL = 8e-3
# One training step through the kernels against the same step with the
# plain attention (f32, TF32 off). Loss terms: relative, 1e-4 (f32 sums of
# the forward in another order; 1.3e-7 seen on an H100). Each updated
# tensor: within 5e-3 of its largest update plus two f32 ulps of its
# largest weight. The two forwards differ only by f32 rounding, and the
# step amplifies that in the grads reaching the attention parameters to
# about 1e-3 of their largest update on an H100, whichever way the
# difference arises: the control step (input scaled by 1 + 1e-7) moves
# them as far. Updates of ~1e-7 on weights of ~0.04
# round to single ulps, hence the ulp term.
STEP_LOSS_RTOL = 1e-4
STEP_UPDATE_RTOL = 5e-3

DEVICE = "cuda"
# the main path: SwinUNETR fs48, sw_batch 4, 96^3 patches, stride 64 on a
# 160x160x128 volume (8 patches, 2 forwards)
FEATURE_SIZE, PATCH, STRIDE, SW_BATCH, VOLUME = 48, 96, 64, 4, (160, 160, 128)
# The attention calls of one such forward: per stage the padded dims,
# window, shift, heads; stages 1-3 shift (region ids), stage 4 (6^3) does not.
STAGES = [
    ("stage1", SW_BATCH, (49, 49, 49), (7, 7, 7), (3, 3, 3), 3),
    ("stage2", SW_BATCH, (28, 28, 28), (7, 7, 7), (3, 3, 3), 6),
    ("stage3", SW_BATCH, (14, 14, 14), (7, 7, 7), (3, 3, 3), 12),
    ("stage4", SW_BATCH, (6, 6, 6), (6, 6, 6), (0, 0, 0), 24),
]
HEAD_DIM = 16
# launches of each variant per forward at each stage (block 0 no-mask,
# block 1 region where the stage shifts)
PER_FORWARD = {"none": {"stage1": 1, "stage2": 1, "stage3": 1, "stage4": 2},
               "region": {"stage1": 1, "stage2": 1, "stage3": 1}}
REPLACES = {"none": "icl_tpu/ops/pallas/window_attention.py:44",
            "region": "icl_tpu/ops/pallas/window_attention.py:60",
            "mask": "icl_tpu/ops/pallas/window_attention.py:28"}
BWD_REPLACES = "icl_tpu/ops/pallas/window_attention.py:290"
# The forward kernel before its tensor-core redesign: f32 ms per launch by
# (stage, mode), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel
# table, the column before the redesign). The 3D stages 2-4 were not
# written down one by one.
FWD_BEFORE_MS = {("stage1", "none"): 2.944, ("stage1", "region"): 3.006}
FWD2D_BEFORE_MS = {("stage1", "none"): 0.559, ("stage2", "none"): 0.291, ("stage3", "none"): 0.156,
                   ("stage4", "none"): 0.101, ("ref224_stage1", "none"): 0.147, ("stage1", "mask"): 0.797,
                   ("stage2", "mask"): 0.410, ("stage3", "mask"): 0.265, ("ref224_stage1", "mask"): 0.190}
# The backward kernel before its tensor-core redesign: f32 ms per launch by
# (stage, mode), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel
# table, the earlier kernel's column). The 3D stages 2-4 and the extra 2D
# windows were not written down one by one.
BWD_BEFORE_MS = {("stage1", "none"): 5.178, ("stage1", "region"): 5.353}
BWD2D_BEFORE_MS = {("stage1", "none"): 1.849, ("stage2", "none"): 0.948, ("stage3", "none"): 0.651,
                   ("stage4", "none"): 0.339, ("stage1", "mask"): 1.961, ("stage2", "mask"): 0.949,
                   ("stage3", "mask"): 0.631}

# The training path: SwinUNETR-ICL fs48 at 96^3, batch 4 of which 2
# labeled; each backbone pass runs batch 2, so the attention shapes are
# those of STAGES at batch 2.
TRAIN_BATCH, LABELED_BS, TRAIN_STEPS, CASE_SIZE = 4, 2, 3, 128
# kernel launches per training step: two backbone passes, each with
# PER_FORWARD's calls, and recompute runs every Swin block's forward again
BWD_PER_STEP_BY_STAGE = {m: {st: 2 * n for st, n in PER_FORWARD[m].items()} for m in ("none", "region")}
BWD_PER_STEP = {m: sum(w.values()) for m, w in BWD_PER_STEP_BY_STAGE.items()}
FWD_PER_STEP = {m: 2 * n for m, n in BWD_PER_STEP.items()}

# This slice: Swin-UNet-ICL 2D, Swin-T lite widths (embed 96, depths
# 2-2-2-2, heads 3-6-12-24: head dim 32) at 384^2 with window 12 (N = 144),
# the window/size pair of Swin's public 384-px configs; batch 16 of which
# 8 labeled, so each backbone pass runs batch 8.
IMG_2D, WINDOW_2D, CLASSES_2D, BATCH_2D, LABELED_2D, HEAD_DIM_2D = 384, 12, 4, 16, 8, 32
SLICE_SIZE_2D, SLICES_2D, LABELED_SLICES_2D, VOLUMES_2D, VOL_DEPTH_2D = 256, 32, 16, 2, 10
# The attention calls of one backbone pass at batch 8: per shape the grid
# side, the window, the heads and the launches of each mode. Stages 1-3
# shift in their odd block, in the encoder and in the decoder stage of the
# same size (layers_up.3, .2, .1); stage 4 (12^2) is one unshifted window.
STAGES_2D = [
    ("stage1", 96, 12, 3, {"none": 2, "mask": 2}),
    ("stage2", 48, 12, 6, {"none": 2, "mask": 2}),
    ("stage3", 24, 12, 12, {"none": 2, "mask": 2}),
    ("stage4", 12, 12, 24, {"none": 2}),
]
# stage 1 of the reference's 224^2 / window-7 configuration (N = 49), and
# a window of 2 x 2 tokens (N = 4, fewer keys than a lane's first tile of the
# backward holds: a stage of 2 x 2 tokens shrinks the window to 2), shifted
# by 1 on a 4 x 4 grid for the mask
REF_STAGE_2D = ("ref224_stage1", 56, 7, 3, {"none": 2, "mask": 2})
TINY_STAGE_2D = ("window2", 4, 2, 24, {"none": 2, "mask": 2})
PER_FORWARD_2D = {m: sum(st[4].get(m, 0) for st in STAGES_2D) for m in ("none", "mask")}
PER_STEP_2D = {m: 2 * n for m, n in PER_FORWARD_2D.items()}  # two passes, no recompute
# This slice: U-Net-ICL 2D at the JAX U-Net CLI's defaults (256^2, batch 16
# of which 8 labeled, 4 classes) on phase 14's slices and volumes; its step
# on the card against the CPU at 64^2.
IMG_UNET, IMG_UNET_CPU = 256, 64
# This slice: the 3D U-Net family at the JAX 3D U-Net CLIs' defaults:
# U-Net-ICL 3D, filters (16, 32, 64, 128, 256), ICL heads on (256, 128, 64)
# channels, heads (16, 8, 4), resolutions (6, 12, 24) (`mlp2` 13824^2 at the
# finest), 96^3, batch 4 of which 2 labeled, consistency weight 10: on
# BraTS (phase 9's 128^3 cases, 2 classes, f32) and on AMOS22 (a seeded
# NIfTI tree, 16 classes, pse weight 0.1, base LR 0.02, bf16 autocast,
# recompute on); its step on the card against the CPU at 32^3. The AMOS
# tree holds 4 training cases (the supervised CLI's batch of 4 needs 4
# labeled ones) and 1 validation case, (96, 96, 72) voxels at spacing
# (2, 2, 3), about 127 x 127 x 107 at the protocol's spacing.
UNET3D_CPU = 32
AMOS_CASES, AMOS_SHAPE, AMOS_SPACING = 5, (96, 96, 72), (2.0, 2.0, 3.0)
# This slice: the fully supervised baselines at the JAX supervised CLIs'
# defaults, each through its CLI's `main` on in-memory data (the card's
# machine has no h5py): the 2D U-Net (256^2, batch 16, f32), Swin-UNet
# (embed 96, 224^2, window 7, batch 16, f32: one backbone pass at batch 16,
# N = 49) and SwinUNETR (fs48, 96^3, batch 4, bf16 autocast, recompute on:
# one pass at batch 4, so stage 1 runs [1372, 3, 343, 16]); then a resume of
# the flagship U-Net-ICL 2D at full width.
IMG_SWIN_SUP, WINDOW_SWIN_SUP, BATCH_SWIN_SUP = 224, 7, 16
# The attention calls of one Swin-UNet pass at 224^2 / window 7: per shape
# the grid side, the window, the heads and the launches of each mode.
# Stages 1-3 shift in their odd block, in the encoder and in the decoder
# stage of the same size; stage 4 (7^2 tokens) is one unshifted window.
STAGES_SWIN_SUP = [
    ("w7_stage1", 56, 7, 3, {"none": 2, "mask": 2}),
    ("w7_stage2", 28, 7, 6, {"none": 2, "mask": 2}),
    ("w7_stage3", 14, 7, 12, {"none": 2, "mask": 2}),
    ("w7_stage4", 7, 7, 24, {"none": 2}),
]
PER_FORWARD_SWIN_SUP = {m: sum(st[4].get(m, 0) for st in STAGES_SWIN_SUP) for m in ("none", "mask")}
# the SwinUNETR supervised step: one pass at batch 4 and its recompute
SUP_3D_FWD_PER_STEP = {m: 2 * sum(PER_FORWARD[m].values()) for m in ("none", "region")}
SUP_3D_BWD_PER_STEP = {m: sum(PER_FORWARD[m].values()) for m in ("none", "region")}
RESUME_STEPS = 4
# This slice: FixMatch-CTA at the JAX CLI's defaults (the U-Net, 256^2, batch
# 16 of which 8 labeled, 4 classes, threshold 0.95, unsupervised weight 1)
# on phase 14's slices; its step at 64^2 on the card against the CPU; the
# resume of its rate-lag-1 run.
CTA_EXP, CTA_EXP_LAG0 = "ACDC_chip_smoke/FixMatch_CTA", "ACDC_chip_smoke/FixMatch_CTA_lag0"
CTA_STEPS, CTA_HOST_BATCHES, CTA_TIMED_STEPS = 4, 5, 3
CTA_SLICE_WIDTH = 216  # phase 33's host batches also from 256 x 216 slices
# the fused probe against a separate forward of the same weights: one f32
# forward in another call
CTA_PROXIMITY_ATOL = 1e-5
# The f32 FixMatch step against the f64 one: the CPU's own f32 step, the
# witness, puts decoder.up1.conv.conv_conv.4.weight at 1.8x the fixed
# allowance (f32 cancellation in the grads of the convs that feed a
# train-mode BatchNorm), where the card's f32 step stays within it on an
# H100; a tensor may part from the f64 step by the fixed allowance or by
# this many times the witness's distance, whichever is larger.
STEP_WITNESS_FACTOR = 2.0
ROOT = os.path.dirname(os.path.abspath(__file__))
EXPERIMENTS = os.path.join(ROOT, "build", "chip_smoke", "experiments")
AMOS_ROOT = os.path.join(ROOT, "build", "chip_smoke", "amos")  # ../experiments is EXPERIMENTS
SUP_ROOT = os.path.join(ROOT, "build", "chip_smoke", "acdc")  # ../experiments is EXPERIMENTS


STARTED: list = []  # the worker processes this process started (`start_ranks`)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    for p in STARTED:  # no worker outlives a failure
        if p.poll() is None:
            p.kill()
            p.wait()
    sys.exit(1)


# Set by `bench_kernels.py --device-time`: cuda_ms then queues the timed
# launches behind a GPU sleep (~25 ms at the H100's clock), so that the
# events time the device's work alone, not the host's time to issue each
# launch, which sets the time of the smallest shapes.
QUEUE_BEHIND_SLEEP = False
SLEEP_CYCLES = 50_000_000


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if QUEUE_BEHIND_SLEEP:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_inputs(torch, stage, dtype, gen, head_dim=HEAD_DIM):
    from icl_tpu_torch.models.swinunetr import window_region_ids_3d

    name, batch, padded, ws, shift, heads = stage
    nW = (padded[0] // ws[0]) * (padded[1] // ws[1]) * (padded[2] // ws[2])
    N = ws[0] * ws[1] * ws[2]
    B = batch * nW
    q, k, v = (torch.randn(B, heads, N, head_dim, device=DEVICE, generator=gen).to(dtype)
               for _ in range(3))
    bias = torch.randn(heads, N, N, device=DEVICE, generator=gen)
    ids = window_region_ids_3d(padded, ws, shift)
    return q, k, v, bias, None if ids is None else torch.from_numpy(ids).to(DEVICE)


def bound(B, H, N, D, mask_floats=0, backward=False, elem_bytes=4, flops_rate=F32_ACCURATE_FLOPS):
    """(ms at the type's rate, ms at the memory rate). Forward: two N x N x D
    products per (window, head); q, k, v read and out written once, bias
    read once. Backward: five products; q, k, v, dO read and dq, dk, dv
    written once, bias read and dbias written once. The region ids [nW, N]
    or the dense mask [nW, N, N] (`mask_floats` values) read once. q, k, v
    and their grads take `elem_bytes` each (2 in bf16), the rest 4; the
    products run at `flops_rate` (BF16_FLOPS in bf16)."""
    products, tensors, bias_arrays = (5, 7, 2) if backward else (2, 4, 1)
    flops = 2 * products * B * H * N * N * D
    nbytes = tensors * B * H * N * D * elem_bytes + (bias_arrays * H * N * N + mask_floats) * 4
    return flops / flops_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def ptxas_usage(log: str, source: str) -> dict:
    """{"<type> <dims> <mode>": [registers, spill stores in bytes]} of each
    kernel instance of library `source`, from its `-Xptxas -v` build log.
    <dims>: "d<=16" an instance that reads the head dim at run time, for
    every head dim of its tile; the forward's "D16" the instance of head dim
    16 itself and "d<16" that of the head dims below; the forward's
    "d<=64" its tile-64 kernel (" lse": the instance that stores the row
    log-sum-exp), whose registers are those a thread starts with (its
    warpgroups then move them with setmaxnreg); "dq" and "dkdv" the tile-64
    backward's two kernels; "d>64" the chunked tile-64 kernels of the
    `_wide` libraries (head dims above 64); "stream fwd", "stream dq" and
    "stream dkdv" the streamed libraries' kernels (every head dim)."""
    import re

    out, name = {}, None
    modes = ("none", "region", "mask")
    types = r"I(f|13__nv_bfloat16)"
    for line in log.splitlines():
        m = re.search(source + "_kernel" + types + r"Li(\d+)ELi(\d)E(?:Lb(\d)E)?(?:Lb(\d)E)?", line)
        m64 = re.search(r"window_attention_bwd64_(wide_)?(dq|dkdv)_kernel" + types + r"Li(\d)E", line)
        f64 = re.search(r"window_attention64_(wide_)?kernel" + types + r"Li(\d)ELb(\d)E", line)
        st = re.search(r"window_attention_stream_(fwd|dq|dkdv)_kernel" + types + r"Li(\d)E(?:Lb(\d)E)?", line)
        if st:
            name = (f"{'f32' if st[2] == 'f' else 'bf16'} stream {st[1]} {modes[int(st[3])]}"
                    f"{' lse' if st[4] == '1' else ''}")
        elif m:
            dims = f"d<={m[2]}" if m[4] is None else f"D{m[2]}" if m[4] == "1" else f"d<{m[2]}"
            name = f"{'f32' if m[1] == 'f' else 'bf16'} {dims} {modes[int(m[3])]}{' lse' if m[5] == '1' else ''}"
        elif f64:
            name = (f"{'f32' if f64[2] == 'f' else 'bf16'} {'d>64' if f64[1] else 'd<=64'} {modes[int(f64[3])]}"
                    f"{' lse' if f64[4] == '1' else ''}")
        elif m64:
            name = f"{'f32' if m64[3] == 'f' else 'bf16'} {m64[2]}{' d>64' if m64[1] else ''} {modes[int(m64[4])]}"
        elif name and "spill stores" in line:
            out[name] = [None, int(re.search(r"(\d+) bytes spill stores", line)[1])]
        elif name and "registers" in line:
            out.setdefault(name, [None, 0])[0] = int(re.search(r"Used (\d+) registers", line)[1])
            name = None
    return out


def bound_fields(flop_ms, byte_ms) -> dict:
    return {"flop_ms": flop_ms, "byte_ms": byte_ms, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def saved_forward(wa, q, k, v, bias, ids, mask, scale) -> dict:
    """The keywords a direct backward call needs: at head dims above
    `wa.SAVED_LSE_ABOVE` (the tile-64 backward) the forward kernel's output
    and row log-sum-exp, as `WindowAttentionFn` saves them; none at the
    smaller head dims, or for a package whose backward takes none."""
    if q.shape[-1] <= getattr(wa, "SAVED_LSE_ABOVE", 64):
        return {}
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    return {"out": out, "lse": lse}


def lse_plain_errors(wa, q, k, v, bias, ids, mask, g, scale, saved, got) -> dict:
    """Each gradient's error, as `rel_err`, against the plain version of the
    tile-64 arithmetic on the same inputs (`window_attention_plain_bwd_lse`
    from the saved output and log-sum-exp); {} where nothing was saved."""
    if not saved:
        return {}
    want = wa.window_attention_plain_bwd_lse(q, k, v, bias, ids, saved["out"], saved["lse"], g, scale=scale,
                                             mask=mask)
    return {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv", "dbias"), got, want)}


def sdpa_backward_ms(torch, F, q, k, v, bias, mask, g, scale) -> float:
    """The backward of F.scaled_dot_product_attention with attn_mask =
    bias (+ the dense mask [nW, N, N]), in q's dtype, for q, k, v and the
    bias, timed on a retained graph."""
    B, H, N, D = q.shape
    nW = mask.shape[0] if mask is not None else B
    shape = (B // nW, nW, H, N, D) if mask is not None else (B, H, N, D)
    qs, ks, vs = (t.detach().view(shape).requires_grad_(True) for t in (q, k, v))
    mask_leaf = bias.detach().to(q.dtype).clone().requires_grad_(True)
    attn = mask_leaf if mask is None else mask_leaf[None] + mask[:, None].to(q.dtype)
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn, scale=scale)
    gout = g.view(shape)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs, mask_leaf), gout, retain_graph=True))


def forward_lse_error(torch, wa, q, k, v, bias, ids, mask, scale, got) -> dict:
    """At head dims above `wa.SAVED_LSE_ABOVE` (the tile-64 forward), the
    forward kernel's row log-sum-exp against the plain version's: {"lse_max_abs_err":
    its largest error}, after checking that the output with the store has
    the bits of `got`, the output without it, and that the error is within
    F32_ATOL of the log-sum-exp's magnitude; {} at the smaller head dims."""
    if q.shape[-1] <= getattr(wa, "SAVED_LSE_ABOVE", 64):
        return {}
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    _, want = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    err = float((lse - want).abs().max())
    if not torch.equal(out, got) or err > F32_ATOL * max(1.0, float(want.abs().max())):
        fail(f"the forward's log-sum-exp store changed its output or disagrees with plain: lse error {err}")
    return {"lse_max_abs_err": err}


def phase_kernel_3d(torch, F, wa, head_dim=HEAD_DIM, stages=STAGES, timed=True,
                    tag="[kernel]", timed_bf16=False) -> list[dict]:
    """3 + 4: the forward kernel against its plain version at the shapes of
    one SwinUNETR inference forward (fs48: head dim 16; `head_dim` and
    `stages` choose others), f32 and bf16, bitwise-repeatable (above head
    dim 32 its log-sum-exp too, forward_lse_error); with `timed` the f32
    times beside the bound, and with `timed_bf16` the bf16 ones too (SDPA
    in bf16 beside them)."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    per_shape = []
    for stage in stages:
        name = stage[0]
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias, ids = stage_inputs(torch, stage, dtype, gen, head_dim)
                ids = ids if mode == "region" else None
                scale = head_dim ** -0.5
                got = wa.window_attention(q, k, v, bias, ids, scale=scale)
                again = wa.window_attention(q, k, v, bias, ids, scale=scale)
                torch.cuda.synchronize()
                want = wa.window_attention_plain(q, k, v, bias, ids, scale=scale)
                err = (got.float() - want.float()).abs()
                max_err = float(err.max())
                if dtype == torch.float32:
                    ok = max_err <= F32_ATOL
                else:
                    ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
                row = {"stage": name, "mode": mode, "dtype": str(dtype).split(".")[-1],
                       "shape": list(q.shape), "nW": ids.shape[0] if ids is not None else None,
                       "max_abs_err": max_err, "bitwise_repeat": torch.equal(got, again)}
                if not ok or not row["bitwise_repeat"] or not torch.isfinite(got).all():
                    fail(f"kernel disagrees with plain or is not repeatable: {row}")
                row.update(forward_lse_error(torch, wa, q, k, v, bias, ids, None, scale, got))
                if timed and (dtype == torch.float32 or timed_bf16):
                    B, H, N, D = q.shape
                    nW = ids.shape[0] if ids is not None else B
                    if ids is None:
                        mask = bias.to(dtype)
                        qs, ks, vs = q, k, v
                    else:
                        mask = (bias[None] + wa.mask_from_region_ids(ids)[:, None]).to(dtype)  # [nW, H, N, N]
                        qs, ks, vs = (t.view(B // nW, nW, H, N, D) for t in (q, k, v))
                    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)
                    lib_err = float((lib_out.reshape(q.shape).float() - want.float()).abs().max())
                    row.update(
                        ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, ids, scale=scale)),
                        plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, scale=scale)),
                        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            qs, ks, vs, attn_mask=mask, scale=scale)),
                        library_max_abs_err=lib_err,
                        before_ms=FWD_BEFORE_MS.get((name, mode)) if head_dim == HEAD_DIM else None,
                        **bound_fields(*bound(B, H, N, D, ids.numel() if ids is not None else 0,
                                              elem_bytes=4 if dtype == torch.float32 else 2,
                                              flops_rate=F32_ACCURATE_FLOPS if dtype == torch.float32
                                              else BF16_FLOPS)),
                    )
                    del mask, lib_out
                per_shape.append(row)
                print(f"{tag} {json.dumps(row)}", flush=True)
                del q, k, v, bias, got, again, want, err
    torch.cuda.empty_cache()
    return per_shape


def phase_backward_kernel(torch, F, wa, head_dim=HEAD_DIM, stages=STAGES, timed=True,
                          tag="[bwd]") -> list[dict]:
    """7 + 8: the backward kernel against its plain version at the training
    shapes (fs48: head dim 16; `head_dim` and `stages` choose others), f32
    and bf16, bitwise-repeatable; with `timed` the f32 times beside the
    bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for stage in stages:
        name = stage[0]
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias, ids = stage_inputs(torch, (name, LABELED_BS) + stage[2:], dtype, gen,
                                                  head_dim)
                ids = ids if mode == "region" else None
                g = torch.randn(q.shape, device=DEVICE, generator=gen).to(dtype)
                scale = head_dim ** -0.5
                saved = saved_forward(wa, q, k, v, bias, ids, None, scale)
                got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, **saved)
                again = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, **saved)
                torch.cuda.synchronize()
                want = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale)
                names = ("dq", "dk", "dv", "dbias")
                errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
                tols = {n: BWD_F32_RTOL if dtype == torch.float32 or n == "dbias" else BWD_BF16_RTOL
                        for n in names}
                lse_errs = lse_plain_errors(wa, q, k, v, bias, ids, None, g, scale, saved, got)
                row = {"stage": name, "mode": mode, "dtype": str(dtype).split(".")[-1],
                       "shape": list(q.shape), "nW": ids.shape[0] if ids is not None else None,
                       "rel_err": errs, "tolerance": tols,
                       "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                          for a, b in zip(got, want)),
                       "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again))}
                if lse_errs:
                    row["rel_err_lse_plain"] = lse_errs
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                if (not finite or not row["bitwise_repeat"] or any(errs[n] > tols[n] for n in names)
                        or any(lse_errs[n] > tols[n] for n in lse_errs)):
                    fail(f"backward kernel disagrees with plain or is not repeatable: {row}")
                if timed and dtype == torch.float32:
                    B, H, N, D = q.shape
                    dense = wa.mask_from_region_ids(ids) if ids is not None else None
                    row.update(
                        ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale,
                                                                   **saved)),
                        plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                            q, k, v, bias, ids, g, scale=scale), reps=3),
                        library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, dense, g, scale),
                        before_ms=BWD_BEFORE_MS.get((name, mode)) if head_dim == HEAD_DIM else None,
                        **bound_fields(*bound(B, H, N, D, ids.numel() if ids is not None else 0,
                                              backward=True)),
                    )
                rows.append(row)
                print(f"{tag} {json.dumps(row)}", flush=True)
                del q, k, v, g, bias, got, again, want, saved
                torch.cuda.empty_cache()
    return rows


def train_config(precision: str, max_iterations: int, val_interval: int, tries: str):
    from icl_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(
        root_path="in-memory", exp="BraTS_chip_smoke/ICL", model="swinunetr_icl", num_classes=2,
        max_iterations=max_iterations, batch_size=TRAIN_BATCH, labeled_bs=LABELED_BS,
        base_lr=0.01, patch_size=(PATCH,) * 3, seed=1337, labeled_num=2, num_tries=tries,
        consis_weight=10.0, val_interval=val_interval, log_interval=1, precision=precision,
        remat=True, feature_size=FEATURE_SIZE, experiments_dir=EXPERIMENTS)


def phase_training(torch, wa, cases, held_out) -> dict:
    """9: Trainer.fit at full width, then one bf16 step. Returns, under
    "trainer", the f32 Trainer and its initial train state (phase 10's)."""
    import copy
    import gc

    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, brats_evaluator

    cfg = train_config("float32", TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    build_s = time.perf_counter() - t0
    initial = copy.deepcopy(trainer.train_state())  # phase 10 starts from it
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size,
                                  seed=cfg.seed)
    validate = brats_evaluator(held_out, 2, cfg.patch_size, trainer.device)
    per_steps = {}

    def evaluate(model):
        # the steps' launches, before the validation's forward launches
        per_steps["fwd"] = dict(wa.window_attention.launches_by_mode)
        per_steps["bwd"] = dict(wa.window_attention_bwd.launches_by_mode)
        return validate(model)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    result = trainer.fit(batches, evaluate=evaluate, class_names=["WT"])
    torch.cuda.synchronize()
    drop_states(result)
    path = {"fwd": dict(wa.window_attention.launches_by_mode),
            "bwd": dict(wa.window_attention_bwd.launches_by_mode)}
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged steps and a validation, got {result}")
    bad = [(r["iteration"], k) for r in log for k in METRIC_KEYS if not math.isfinite(r[k])]
    if bad:
        fail(f"non-finite loss terms {bad}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    steps_launches = {kind: {m: n / TRAIN_STEPS for m, n in c.items()} for kind, c in per_steps.items()}
    print(f"[train] SwinUNETR-ICL fs{FEATURE_SIZE}, {n_params} params, built in {build_s:.1f} s; "
          f"{PATCH}^3 batch {TRAIN_BATCH} ({LABELED_BS} labeled), f32, TF32 off, recompute on: "
          f"{s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start); peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step {steps_launches}; "
          f"whole run with validation {path}", flush=True)
    for r in log:
        print(f"[train] step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in METRIC_KEYS), flush=True)
    val = result["vals"][-1]
    print(f"[train] validation at step {val['iteration']} on one held-out {CASE_SIZE}^3 case: "
          f"mean dice {val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint "
          f"{result['best_path']}", flush=True)
    want = {"fwd": FWD_PER_STEP, "bwd": BWD_PER_STEP}
    for kind in ("fwd", "bwd"):
        if per_steps[kind] != {**{m: TRAIN_STEPS * n for m, n in want[kind].items()}, "mask": 0}:
            fail(f"{kind} launches over {TRAIN_STEPS} steps: {per_steps[kind]}, expected "
                 f"{want[kind]} per step")
    if result["best_path"] is None:
        fail(f"validation dice {val['mean_dice']}: no best checkpoint was saved")

    cfg16 = train_config("bfloat16", 1, 0, "bfloat16")
    trainer16 = Trainer(cfg16, device=DEVICE)
    batch16 = next(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS,
                                       cfg16.patch_size, seed=cfg16.seed))
    log16 = [dict(zip(METRIC_KEYS, trainer16.train_step(trainer16.to_device(batch16)).tolist()))]
    print("[train] one bfloat16 autocast step: "
          + " ".join(f"{k} {log16[0][k]:.6f}" for k in METRIC_KEYS), flush=True)
    if not all(math.isfinite(log16[0][k]) for k in METRIC_KEYS):
        fail("non-finite loss under bfloat16")
    del trainer16
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": path,
            "val_dice": val["mean_dice"], "best_path": result["best_path"], "log": log,
            "trainer": (trainer, initial)}


def phase_step_parity(torch, wa, cases, built) -> None:
    """10: one SwinUNETR-ICL step through the kernels against the plain
    attention (stages 1 and 4 watched); then, on the same model, the fused
    sspa pair against the two calls (`fused_pair_agreement`). `built`:
    phase 9's Trainer of the same model and its initial train state, each
    step starting from that state."""
    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.models.swinunetr import WindowAttention3D

    cfg = train_config("float32", 1, 0, "step")
    batch = next(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size,
                                     seed=cfg.seed))
    watched = [f"swinViT.layers{i}.0.blocks.{b}.attn.{t}" for i in (1, 4) for b in (0, 1)
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]
    kernel_launches = (sum(FWD_PER_STEP.values()), sum(BWD_PER_STEP.values()))
    step_parity(torch, wa, cfg, batch, watched, WindowAttention3D, kernel_launches, "[step]",
                built=built,
                then=lambda model: fused_pair_agreement(torch, wa, model, batch, cfg.patch_size,
                                                        "[fused-swinunetr]", classes=2,
                                                        labeled=LABELED_BS, consis=cfg.consis_weight))


def step_parity(torch, wa, cfg, batch, watched, attention_type, kernel_launches, tag, then=None,
                built=None) -> None:
    """One f32 step through the kernels against the same step (same
    weights, same batch, drop path off) with the plain attention, beside a
    control: the kernel step on the batch scaled by 1 + 1e-7, which shows
    how far f32 rounding of the forward alone moves the step. One model,
    its train state put back before each step: a Trainer of `cfg`, or
    `built`, a (Trainer, its initial train state) of the same model, whose
    step at that state is cfg's; `then(model)`, if given, runs on it after,
    with the state put back and the kernels in place."""
    import copy
    import gc

    from icl_tpu_torch.models.layers import DropPath
    from icl_tpu_torch.train.trainer import Trainer

    if built is None:
        trainer = Trainer(cfg, device=DEVICE)
        s0 = copy.deepcopy(trainer.train_state())
    else:
        trainer, s0 = built
    attentions = [m for m in trainer.model.modules() if isinstance(m, attention_type)]
    for m in trainer.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    params = dict(trainer.model.named_parameters())

    def one_step(plain: bool, input_scale: float = 1.0):
        trainer.load_train_state(s0)
        for m in attentions:
            m.attention = wa.window_attention_plain if plain else wa.window_attention
        before = {n: params[n].detach().clone() for n in watched}
        on_card = trainer.to_device(batch)
        on_card["image"] = on_card["image"] * input_scale
        wa.reset_launch_counts()
        metrics = {k: float(v) for k, v in trainer.step_fn(on_card).items()}
        launches = (wa.window_attention.launches, wa.window_attention_bwd.launches)
        after = {n: params[n].detach().clone() for n in watched}
        return metrics, before, after, launches

    kern, plain, ctl = one_step(False), one_step(True), one_step(False, 1.0 + 1e-7)
    launches = [run[3] for run in (kern, plain, ctl)]
    if launches != [kernel_launches, (0, 0), kernel_launches]:
        fail(f"(forward, backward) launches of the kernel, plain and control steps: {launches}, "
             f"expected {[kernel_launches, (0, 0), kernel_launches]}")
    for n in watched:
        if not (torch.equal(kern[1][n], plain[1][n]) and torch.equal(kern[1][n], ctl[1][n])):
            fail(f"{n}: the steps did not start from the same weights")

    def loss_err(a, b):
        return {k: abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-12) for k in b[0]}

    def update_err(a, b):
        """max |a - b| of each new value over the allowance: the tolerance
        times the largest update, plus two f32 ulps of the largest weight."""
        out = {}
        for n in watched:
            allow = (STEP_UPDATE_RTOL * float((b[2][n] - b[1][n]).abs().max())
                     + 2 * torch.finfo(torch.float32).eps * float(b[1][n].abs().max()))
            out[n] = float((a[2][n] - b[2][n]).abs().max()) / allow
        return out

    errs = {"kernel_vs_plain": (loss_err(kern, plain), update_err(kern, plain)),
            "control_vs_kernel": (loss_err(ctl, kern), update_err(ctl, kern))}
    print(f"{tag} one f32 step, kernel vs plain attention: loss terms {kern[0]} vs {plain[0]}",
          flush=True)
    for name, (le, ue) in errs.items():
        print(f"{tag} {name}: loss terms' relative errors {le} (tolerance {STEP_LOSS_RTOL}); "
              f"updated tensors' errors as fractions of their allowance {ue}", flush=True)
    le, ue = errs["kernel_vs_plain"]
    if any(e > STEP_LOSS_RTOL for e in le.values()) or any(e > 1.0 for e in ue.values()):
        fail("the training step through the kernels disagrees with the plain-attention step")
    if then is not None:
        trainer.load_train_state(s0)
        for m in attentions:
            m.attention = wa.window_attention
        s0 = built = None  # free the initial state
        then(trainer.model)
    del trainer, s0, built, params, attentions
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_to_eval(torch, held_out, training: dict) -> None:
    """11: the stripped best checkpoint through the eval CLI's loader."""
    from icl_tpu_torch.eval.infer3d import evaluate_brats_cases, make_patch_predictor
    from icl_tpu_torch.metrics import aggregate_case_metrics
    from icl_tpu_torch.scripts.test_3D_BraTS import load_eval_model

    model = load_eval_model("swinunetr_icl", training["best_path"], 2, DEVICE, FEATURE_SIZE)
    agg = aggregate_case_metrics(evaluate_brats_cases(
        make_patch_predictor(model), held_out, 2, (PATCH,) * 3, STRIDE, STRIDE, sw_batch=SW_BATCH,
        device=DEVICE))
    print(f"[eval] stripped best checkpoint, loaded strictly into {type(model).__name__}: mean dice "
          f"{agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}", flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


def inputs_2d(torch, stage, dtype, gen, kind, batch=LABELED_2D, head_dim=HEAD_DIM_2D):
    """q, k, v, bias and the mask of one Swin-UNet 2D attention shape at
    `batch`: `kind` None (no mask), "shift" (the shifted block's mask) or
    "random" (a dense mask N(0, 3^2): the kernels take any)."""
    from icl_tpu_torch.models.swin2d import shifted_window_mask

    _, side, ws, heads, _ = stage
    nW, N = (side // ws) ** 2, ws * ws
    q, k, v = (torch.randn(batch * nW, heads, N, head_dim, device=DEVICE, generator=gen)
               .to(dtype) for _ in range(3))
    bias = torch.randn(heads, N, N, device=DEVICE, generator=gen)
    mask = None
    if kind == "shift":
        mask = torch.from_numpy(shifted_window_mask(side, side, ws, ws // 2)).to(DEVICE)
    elif kind == "random":
        mask = 3.0 * torch.randn(nW, N, N, device=DEVICE, generator=gen)
    return q, k, v, bias, mask


def check_2d(torch, F, wa, stage, mode, kind, dtype, gen, batch=LABELED_2D, timed=None,
             tag="2d", head_dim=HEAD_DIM_2D) -> tuple[dict, dict]:
    """The forward and backward kernels at one 2D shape against their plain
    versions, bitwise-repeatable; timed (f32 with the shift mask or none,
    unless `timed` says) beside the bound, the plain version and SDPA."""
    scale = head_dim ** -0.5
    q, k, v, bias, mask = inputs_2d(torch, stage, dtype, gen, kind, batch, head_dim)
    B, H, N, D = q.shape
    nW = mask.shape[0] if mask is not None else B
    if timed is None:
        timed = dtype == torch.float32 and kind != "random"
    got = wa.window_attention(q, k, v, bias, mask=mask, scale=scale)
    again = wa.window_attention(q, k, v, bias, mask=mask, scale=scale)
    torch.cuda.synchronize()
    want = wa.window_attention_plain(q, k, v, bias, mask=mask, scale=scale)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        ok = float(err.max()) <= F32_ATOL
    else:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    row = {"stage": stage[0], "mode": mode, "mask": kind, "dtype": str(dtype).split(".")[-1],
           "shape": list(q.shape), "nW": nW if mask is not None else None,
           "max_abs_err": float(err.max()), "bitwise_repeat": torch.equal(got, again)}
    if not ok or not row["bitwise_repeat"] or not torch.isfinite(got).all():
        fail(f"2D kernel disagrees with plain or is not repeatable: {row}")
    row.update(forward_lse_error(torch, wa, q, k, v, bias, None, mask, scale, got))
    if timed:
        shape = (B // nW, nW, H, N, D) if mask is not None else (B, H, N, D)
        qs, ks, vs = (t.view(shape) for t in (q, k, v))
        attn = (bias if mask is None else bias[None] + mask[:, None]).to(dtype)
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn, scale=scale)
        row.update(
            ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, mask=mask, scale=scale)),
            plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, mask=mask,
                                                               scale=scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=attn, scale=scale)),
            library_max_abs_err=float((lib_out.reshape(q.shape).float() - want.float()).abs().max()),
            before_ms=FWD2D_BEFORE_MS.get((stage[0], mode)) if head_dim == HEAD_DIM_2D else None,
            **bound_fields(*bound(B, H, N, D, mask.numel() if mask is not None else 0,
                                  elem_bytes=4 if dtype == torch.float32 else 2,
                                  flops_rate=F32_ACCURATE_FLOPS if dtype == torch.float32 else BF16_FLOPS)),
        )
        del lib_out, attn
    print(f"[kernel{tag}] {json.dumps(row)}", flush=True)
    del again
    g = torch.randn(q.shape, device=DEVICE, generator=gen).to(dtype)
    saved = saved_forward(wa, q, k, v, bias, None, mask, scale)
    got = wa.window_attention_bwd(q, k, v, bias, None, g, scale=scale, mask=mask, **saved)
    again = wa.window_attention_bwd(q, k, v, bias, None, g, scale=scale, mask=mask, **saved)
    torch.cuda.synchronize()
    want = wa.window_attention_plain_bwd(q, k, v, bias, None, g, scale=scale, mask=mask)
    names = ("dq", "dk", "dv", "dbias")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    tols = {n: BWD_F32_RTOL if dtype == torch.float32 or n == "dbias" else BWD_BF16_RTOL
            for n in names}
    lse_errs = lse_plain_errors(wa, q, k, v, bias, None, mask, g, scale, saved, got)
    brow = {k: row[k] for k in ("stage", "mode", "mask", "dtype", "shape", "nW")}
    brow.update(rel_err=errs, tolerance=tols,
                max_abs_err=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(got, want)),
                bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, again)))
    if lse_errs:
        brow["rel_err_lse_plain"] = lse_errs
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    if (not finite or not brow["bitwise_repeat"] or any(errs[n] > tols[n] for n in names)
            or any(lse_errs[n] > tols[n] for n in lse_errs)):
        fail(f"2D backward kernel disagrees with plain or is not repeatable: {brow}")
    if timed:
        brow.update(
            ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, None, g, scale=scale,
                                                       mask=mask, **saved)),
            plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                q, k, v, bias, None, g, scale=scale, mask=mask), reps=3),
            library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, mask, g, scale),
            before_ms=BWD2D_BEFORE_MS.get((stage[0], mode)) if head_dim == HEAD_DIM_2D else None,
            **bound_fields(*bound(B, H, N, D, mask.numel() if mask is not None else 0,
                                  backward=True)),
        )
    print(f"[bwd{tag}] {json.dumps(brow)}", flush=True)
    del q, k, v, bias, mask, g, got, again, want, saved
    torch.cuda.empty_cache()
    return row, brow


def phase_kernels_2d(torch, F, wa) -> tuple[list[dict], list[dict]]:
    """12 + 13: the forward and backward kernels at the 2D shapes (384^2,
    the reference's 224^2 stage 1 and a 2 x 2 window) against their plain
    versions; f32 times with the shift mask."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    fwd_rows, bwd_rows = [], []
    for stage in STAGES_2D + [REF_STAGE_2D, TINY_STAGE_2D]:
        for mode in stage[4]:
            for kind in ((None,) if mode == "none" else ("shift", "random")):
                for dtype in (torch.float32, torch.bfloat16):
                    row, brow = check_2d(torch, F, wa, stage, mode, kind, dtype, gen)
                    fwd_rows.append(row)
                    bwd_rows.append(brow)
    return fwd_rows, bwd_rows


def train_config_2d(max_iterations: int, val_interval: int, tries: str):
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.models.swin2d import SwinConfig

    return ExperimentConfig(
        root_path="in-memory", exp="ACDC_chip_smoke/SwinICL", model="icl_swinunet",
        num_classes=CLASSES_2D, max_iterations=max_iterations, batch_size=BATCH_2D,
        labeled_bs=LABELED_2D, base_lr=0.01, patch_size=(IMG_2D, IMG_2D), seed=1337, labeled_num=7,
        num_tries=tries, consis_weight=50.0, val_interval=val_interval, log_interval=1,
        precision="float32", experiments_dir=EXPERIMENTS,
        model_kwargs={"swin_cfg": SwinConfig(img_size=IMG_2D, window_size=WINDOW_2D)})


def acdc_batches(slices, cfg):
    from icl_tpu_torch.data.pipeline import acdc_train_batches

    return acdc_train_batches(slices, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, cfg.patch_size,
                              seed=cfg.seed)


@contextlib.contextmanager
def timed_cta_parts(parts: dict):
    """A CTA batch's CTAugment ops and zooms timed into `parts` (seconds,
    "cta_ops" and "zooms"): wrappers in place of the names that
    `CTATransform` and `cta_batches`' probe call, for the block only."""
    from icl_tpu_torch.data import pipeline, transforms

    saved = []
    for module in (transforms, pipeline):
        for name, part in (("cta_apply", "cta_ops"), ("zoom_to", "zooms")):
            fn = getattr(module, name)

            def timed_call(*args, _fn=fn, _part=part, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    parts[_part] += time.perf_counter() - t0

            saved.append((module, name, fn))
            setattr(module, name, timed_call)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def host_batches_both_ways(make, n: int, tag: str, split: bool = False) -> tuple[dict, list]:
    """The first `n` batches of `make()`, made on the host twice: through
    the port's C++ rotate and zoom (its default) and through scipy (the
    port's `native.available` switched off in this function only). The
    seconds of each batch each way, the library's calls, and with `split`
    the CTA batch's parts (`timed_cta_parts`); the arrays equal and the
    native way's zooms reaching the library (both asserted). Returns the
    numbers and the native way's batches."""
    import numpy as np

    from icl_tpu_torch import native

    runs, made = {}, {}
    for way in ("native", "scipy"):
        parts = {"cta_ops": 0.0, "zooms": 0.0}
        native.reset_call_counts()
        available = native.available
        if way == "scipy":
            native.available = lambda: False
        try:
            with timed_cta_parts(parts) if split else contextlib.nullcontext():
                batches, seconds, it = [], [], make()
                for _ in range(n):
                    t0 = time.perf_counter()
                    batches.append(next(it))
                    seconds.append(time.perf_counter() - t0)
        finally:
            native.available = available
        runs[way] = {"batch_s": seconds, "mean_s": sum(seconds) / n,
                     "native_calls": {"zoom": native.zoom_nearest.calls,
                                      "rotate": native.rotate_nearest.calls}}
        if split:
            runs[way]["split_s_per_batch"] = {**{k: v / n for k, v in parts.items()},
                                              "rest": (sum(seconds) - sum(parts.values())) / n}
        made[way] = batches
    differ = [(i, k) for i, (g, w) in enumerate(zip(made["native"], made["scipy"])) for k in g
              if not (np.array_equal(g[k], w[k]) if isinstance(g[k], np.ndarray) else g[k] == w[k])]
    print(f"{tag} host batches ({n}) made through the C++ helper and through scipy: "
          f"{json.dumps(runs)}; arrays that differ {differ}", flush=True)
    if differ:
        fail(f"{tag} the native and the scipy host batches differ: {differ}")
    if not runs["native"]["native_calls"]["zoom"] or any(runs["scipy"]["native_calls"].values()):
        fail(f"{tag} the native batches did not reach the library, or the scipy ones did: {runs}")
    return runs, made["native"]


def phase_training_2d(torch, wa, slices, volumes) -> dict:
    """14: Trainer.fit of Swin-UNet-ICL at full width, the main path of
    this slice."""
    import gc

    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator

    cfg = train_config_2d(TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    # the host's time per batch, apart from the run
    host, _ = host_batches_both_ways(lambda: acdc_batches(slices, cfg), TRAIN_STEPS, "[train2d]")
    host_batch_s = host["native"]["mean_s"]
    validate = acdc_evaluator(volumes, CLASSES_2D, cfg.patch_size, trainer.device)
    per_steps, val_s = {}, []

    def evaluate(model):
        per_steps["fwd"] = dict(wa.window_attention.launches_by_mode)
        per_steps["bwd"] = dict(wa.window_attention_bwd.launches_by_mode)
        t0 = time.perf_counter()
        agg = validate(model)  # ends with the label maps on the host
        val_s.append(time.perf_counter() - t0)
        return agg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    result = trainer.fit(acdc_batches(slices, cfg), evaluate=evaluate)
    torch.cuda.synchronize()
    drop_states(result)
    path = {"fwd": dict(wa.window_attention.launches_by_mode),
            "bwd": dict(wa.window_attention_bwd.launches_by_mode)}
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged 2D steps and a validation, got {result}")
    bad = [(r["iteration"], k) for r in log for k in METRIC_KEYS if not math.isfinite(r[k])]
    if bad:
        fail(f"non-finite 2D loss terms {bad}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    chunks = sum(math.ceil(v["image"].shape[0] / 32) for v in volumes)
    val_launches = {m: path["fwd"][m] - per_steps["fwd"][m] for m in PER_FORWARD_2D}
    print(f"[train2d] Swin-UNet-ICL embed 96, {n_params} params, built in {build_s:.1f} s; "
          f"{IMG_2D}^2 window {WINDOW_2D}, batch {BATCH_2D} ({LABELED_2D} labeled), f32, TF32 off: "
          f"{s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start; host batch "
          f"{host_batch_s:.4f} s of it); peak memory {peak / 2**30:.2f} GiB; launches over the "
          f"steps {per_steps}, validation ({chunks} chunks) {val_launches}", flush=True)
    for r in log:
        print(f"[train2d] step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in METRIC_KEYS), flush=True)
    val = result["vals"][-1]
    print(f"[train2d] validation at step {val['iteration']} on {len(volumes)} volumes of "
          f"{VOL_DEPTH_2D} {SLICE_SIZE_2D}^2 slices in {val_s[0]:.4f} s: mean dice "
          f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint {result['best_path']}",
          flush=True)
    for kind in ("fwd", "bwd"):
        if per_steps[kind] != {"none": TRAIN_STEPS * PER_STEP_2D["none"], "region": 0,
                               "mask": TRAIN_STEPS * PER_STEP_2D["mask"]}:
            fail(f"2D {kind} launches over {TRAIN_STEPS} steps: {per_steps[kind]}, expected "
                 f"{PER_STEP_2D} per step")
    if val_launches != {m: chunks * n for m, n in PER_FORWARD_2D.items()} or path["bwd"] != per_steps["bwd"]:
        fail(f"2D validation launches {val_launches} over {chunks} chunks, expected "
             f"{PER_FORWARD_2D} per chunk and no backward")
    if result["best_path"] is None:
        fail(f"2D validation dice {val['mean_dice']}: no best checkpoint was saved")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "host_batch_s": host_batch_s, "host": host, "peak_bytes": peak,
            "path_launches": path, "val_dice": val["mean_dice"], "best_path": result["best_path"],
            "swin_cfg": cfg.model_kwargs["swin_cfg"]}


def phase_step_parity_2d(torch, wa, slices) -> None:
    """15: one Swin-UNet-ICL step through the kernels against the plain
    attention (encoder stages 1 and 4 and the masked decoder block); then,
    on the same model, the fused sspa pair against the two calls."""
    from icl_tpu_torch.models.swin2d import WindowAttention

    cfg = train_config_2d(1, 0, "step")
    blocks = [f"layers.{i}.blocks.{b}" for i in (0, 3) for b in (0, 1)] + ["layers_up.3.blocks.1"]
    watched = [f"swin_unet.{blk}.attn.{t}" for blk in blocks
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]
    per_step = sum(PER_STEP_2D.values())
    batch = next(acdc_batches(slices, cfg))
    step_parity(torch, wa, cfg, batch, watched, WindowAttention, (per_step, per_step), "[step2d]",
                then=lambda model: fused_pair_agreement(torch, wa, model, batch, cfg.patch_size,
                                                        "[fused-swinunet]", classes=CLASSES_2D,
                                                        labeled=LABELED_2D, consis=cfg.consis_weight))


def phase_train_to_eval_2d(torch, volumes, training: dict) -> None:
    """16: the stripped best checkpoint through the 2D eval CLI's loader."""
    from icl_tpu_torch.eval.infer2d import evaluate_acdc_volumes, make_slice_predictor
    from icl_tpu_torch.scripts.test_2D_ACDC import load_eval_model

    patch = (IMG_2D, IMG_2D)
    model = load_eval_model("icl_swinunet", training["best_path"], CLASSES_2D, DEVICE, patch,
                            {"swin_cfg": training["swin_cfg"]})
    agg = evaluate_acdc_volumes(make_slice_predictor(model, patch, DEVICE), volumes, CLASSES_2D)
    print(f"[eval2d] stripped best checkpoint, loaded strictly into {type(model).__name__}: mean "
          f"dice {agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}", flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the 2D eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


def unet_config(max_iterations: int, val_interval: int, tries: str, side: int | None = None,
                **model_kwargs):
    from icl_tpu_torch.config import ExperimentConfig

    side = side or IMG_UNET
    return ExperimentConfig(
        root_path="in-memory", exp="ACDC_chip_smoke/ICL", model="icl_unet", num_classes=CLASSES_2D,
        max_iterations=max_iterations, batch_size=BATCH_2D, labeled_bs=LABELED_2D, base_lr=0.01,
        patch_size=(side, side), seed=1337, labeled_num=7, num_tries=tries, consis_weight=50.0,
        val_interval=val_interval, log_interval=1, precision="float32",
        experiments_dir=EXPERIMENTS, model_kwargs=model_kwargs)


def phase_training_unet(torch, wa, slices, volumes) -> dict:
    """17: Trainer.fit of U-Net-ICL at full width, its batches made on a
    Prefetcher thread; no window attention on this path."""
    import gc

    from icl_tpu_torch.data.pipeline import Prefetcher
    from icl_tpu_torch.scripts.time_fit import timed
    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator

    cfg = unet_config(TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # dropout and drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    host, _ = host_batches_both_ways(lambda: acdc_batches(slices, cfg), TRAIN_STEPS, "[unet]")
    validate = acdc_evaluator(volumes, CLASSES_2D, cfg.patch_size, trainer.device)
    waits, val_s = [], []  # the time each `next` blocks the step's thread; the validation's

    def evaluate(model):
        t0 = time.perf_counter()
        agg = validate(model)  # ends with the label maps on the host
        val_s.append(time.perf_counter() - t0)
        return agg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Prefetcher(acdc_batches(slices, cfg), pin_memory=trainer.device.type == "cuda") as batches:
        wa.reset_launch_counts()
        result = trainer.fit(timed(batches, waits), evaluate=evaluate)
        torch.cuda.synchronize()
        drop_states(result)
        path = {"fwd": dict(wa.window_attention.launches_by_mode),
                "bwd": dict(wa.window_attention_bwd.launches_by_mode)}
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged U-Net steps and a validation, got {result}")
    bad = [(r["iteration"], k) for r in log for k in METRIC_KEYS if not math.isfinite(r[k])]
    if bad:
        fail(f"non-finite U-Net loss terms {bad}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    print(f"[unet] U-Net-ICL, {n_params} params, built and initialised in {build_s:.2f} s; "
          f"{IMG_UNET}^2, batch {BATCH_2D} ({LABELED_2D} labeled), f32, TF32 off: {s_per_step:.4f} "
          f"s/step after the warm-up step (step times {[round(r['seconds'], 4) for r in log]} s "
          f"from the start); the step's thread waited {[round(w, 4) for w in waits]} s for its "
          f"batches (Prefetcher); peak memory {peak / 2**30:.2f} GiB; window-attention launches "
          f"{path}", flush=True)
    for r in log:
        print(f"[unet] step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in METRIC_KEYS), flush=True)
    val = result["vals"][-1]
    print(f"[unet] validation at step {val['iteration']} on {len(volumes)} volumes of "
          f"{VOL_DEPTH_2D} {SLICE_SIZE_2D}^2 slices in {val_s[0]:.4f} s: mean dice "
          f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint {result['best_path']}",
          flush=True)
    if any(n for counts in path.values() for n in counts.values()):
        fail(f"the U-Net path launched window attention: {path}")
    if result["best_path"] is None:
        fail(f"U-Net validation dice {val['mean_dice']}: no best checkpoint was saved")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "waits_s": waits, "host": host, "val_s": val_s[0], "build_s": build_s,
            "n_params": n_params, "peak_bytes": peak, "path_launches": path,
            "val_dice": val["mean_dice"], "best_path": result["best_path"]}


def step_agreement(torch, tag: str, what: str, before: dict, runs: dict) -> None:
    """runs: {"test", "reference"} and optionally "control" and "witness"
    -> (loss terms, parameters after) of one step each from the parameters
    `before` (in the test's dtype); the control is the test's step on the
    batch scaled by 1 + 1e-7, the witness the test's step on the
    reference's device in the test's dtype. Loss terms within
    STEP_LOSS_RTOL; each parameter's new value within STEP_UPDATE_RTOL of
    its largest update plus two ulps of its largest weight, or, where the
    control moves it further, within twice the control's distance, or,
    where the witness lies further from the reference, within
    STEP_WITNESS_FACTOR times the witness's distance: in f32 the gradients
    of the layers that feed a train-mode BatchNorm (the convs, and `mlp2`
    through the SeparableConv) cancel, so a change of the input at the f32
    rounding level, or f32 rounding alone, can move them past the fixed
    allowance (tests/test_torch_train_unet2d.py)."""
    test, ref = runs["test"], runs["reference"]
    ctl, wit = runs.get("control"), runs.get("witness")
    loss_err = {k: abs(test[0][k] - ref[0][k]) / max(abs(ref[0][k]), 1e-12) for k in ref[0]}
    errs, ctl_errs, wit_errs = {}, {}, {}
    for n, w in before.items():
        r = ref[1][n]  # every tensor of the runs where the reference's lies, one at a time
        w, t = w.to(r.device), test[1][n].to(r.device)
        allow = (STEP_UPDATE_RTOL * float((r - w).abs().max())
                 + 2 * torch.finfo(w.dtype).eps * float(w.abs().max()))
        err = float((t - r).abs().max())
        ctl_err = float((ctl[1][n].to(r.device) - t).abs().max()) if ctl else 0.0
        wit_err = float((wit[1][n].to(r.device) - r).abs().max()) if wit else 0.0
        errs[n] = (ratio(err, allow),
                   ratio(err, max(allow, 2 * ctl_err, STEP_WITNESS_FACTOR * wit_err)))
        ctl_errs[n] = ratio(ctl_err, allow)
        wit_errs[n] = ratio(wit_err, allow)
    top = dict(sorted(errs.items(), key=lambda kv: -kv[1][1])[:5])
    beyond = sorted(n for n, (fixed, _) in errs.items() if fixed > 1.0)
    print(f"{tag} {what}: loss terms {test[0]} vs {ref[0]}; relative errors {loss_err} (tolerance "
          f"{STEP_LOSS_RTOL}); of {len(errs)} parameters {len(beyond)} beyond the fixed allowance "
          f"{beyond}; the largest errors as fractions of (the fixed allowance, the rule's) {top}",
          flush=True)
    if ctl:
        top_ctl = dict(sorted(ctl_errs.items(), key=lambda kv: -kv[1])[:5])
        print(f"{tag} the control's largest moves as fractions of the fixed allowance {top_ctl}",
              flush=True)
    if wit:
        top_wit = dict(sorted(wit_errs.items(), key=lambda kv: -kv[1])[:5])
        print(f"{tag} the witness's largest errors as fractions of the fixed allowance {top_wit}; "
              f"the test's errors on those tensors {({n: errs[n][0] for n in top_wit})}",
              flush=True)
    if (any(e > STEP_LOSS_RTOL for e in loss_err.values())
            or any(e > 1.0 for _, e in errs.values())):
        fail(f"{tag} {what}: the steps disagree")


def ratio(err: float, allow: float) -> float:
    """err / allow, with 0 / 0 = 0 (a parameter at zero that no step moved)."""
    return err / allow if allow > 0 else (0.0 if err == 0 else math.inf)


def unet_step(torch, model, batch, patch, device, input_scale: float = 1.0,
              classes: int = CLASSES_2D, labeled: int = LABELED_2D, consis: float = 50.0):
    """(loss terms, parameters after) of one ICL step of `model` (f32 or
    f64) at patch `patch` on `batch`, with a fresh optimizer. The
    parameters are the model's own tensors: clone them before the model
    moves on."""
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_icl_step

    dtype = next(model.parameters()).dtype
    model.zero_grad(set_to_none=True)
    opt = PolySGD(model.parameters(), 0.01, 30000)
    step = make_icl_step(model, opt, classes, labeled, tuple(patch), consis)
    on_device = {"image": torch.as_tensor(batch["image"]).to(device, dtype) * input_scale,
                 "label": torch.as_tensor(batch["label"]).to(device).long()}
    metrics = {k: float(v) for k, v in step(on_device).items()}
    return metrics, {n: p.detach() for n, p in model.named_parameters()}


def phase_unet_device_vs_cpu(torch, slices) -> None:
    """18: one U-Net-ICL step at 64^2 on the card against the CPU."""
    from icl_tpu_torch.models.registry import net_factory

    cfg = unet_config(1, 0, "cpu", side=IMG_UNET_CPU)
    batch = next(acdc_batches(slices, cfg))

    starts = []

    def run(device, scale=1.0):
        model = net_factory("icl_unet", 1, CLASSES_2D, device=device, patch_size=IMG_UNET_CPU,
                            zero_stochastic=True, generator=torch.Generator().manual_seed(cfg.seed))
        starts.append({n: p.detach().cpu().clone() for n, p in model.named_parameters()})
        metrics, after = unet_step(torch, model, batch, (IMG_UNET_CPU,) * 2, device, scale)
        return metrics, {n: t.cpu().clone() for n, t in after.items()}

    t0 = time.perf_counter()
    runs = {"test": run(DEVICE), "reference": run("cpu"), "control": run(DEVICE, 1.0 + 1e-7)}
    if not all(torch.equal(s[n], starts[0][n]) for s in starts for n in starts[0]):
        fail("[unet-cpu] the steps did not start from the same weights")
    step_agreement(torch, "[unet-cpu]", f"one {IMG_UNET_CPU}^2 f32 step, card vs CPU "
                   f"({time.perf_counter() - t0:.1f} s for the three)", starts[0], runs)


def phase_unet_fused_pair(torch, slices) -> None:
    """19: one full-width U-Net-ICL step with the fused sspa pair against the
    two-call step, on the card, in f64 (the two differ by how their GEMMs
    are batched, which in f32 moves the layers that feed a BatchNorm past
    any fixed allowance; in f64 the steps must agree), from one model whose
    weights and BatchNorm stats are reset between the steps."""
    import gc

    from icl_tpu_torch.models.registry import net_factory

    batch = next(acdc_batches(slices, unet_config(1, 0, "fused")))
    model = net_factory("icl_unet", 1, CLASSES_2D, device=DEVICE, patch_size=IMG_UNET,
                        zero_stochastic=True, generator=torch.Generator().manual_seed(0)).double()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()

    def run(fuse: bool):
        model.load_state_dict(start)
        model.fuse_sspa_pair = fuse
        return unet_step(torch, model, batch, (IMG_UNET,) * 2, DEVICE)

    t0 = time.perf_counter()
    metrics, after = run(False)
    reference = (metrics, {n: t.clone() for n, t in after.items()})
    runs = {"test": run(True), "reference": reference}
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    before = {n: start[n] for n in reference[1]}
    step_agreement(torch, "[unet-fused]", f"one {IMG_UNET}^2 f64 step, fused sspa pair vs two calls "
                   f"({step_s:.1f} s for the two; peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", before, runs)
    del model, start, runs, reference, after, before
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_to_eval_unet(torch, volumes, training: dict) -> None:
    """20: the stripped best checkpoint through the 2D eval CLI's loader."""
    from icl_tpu_torch.eval.infer2d import evaluate_acdc_volumes, make_slice_predictor
    from icl_tpu_torch.scripts.test_2D_ACDC import load_eval_model

    patch = (IMG_UNET, IMG_UNET)
    model = load_eval_model("icl_unet", training["best_path"], CLASSES_2D, DEVICE, patch)
    agg = evaluate_acdc_volumes(make_slice_predictor(model, patch, DEVICE), volumes, CLASSES_2D)
    print(f"[eval-unet] stripped best checkpoint, loaded strictly into {type(model).__name__}: mean "
          f"dice {agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}", flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the U-Net eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


def unet3d_config(model: str, precision: str, max_iterations: int, val_interval: int, tries: str):
    from icl_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(
        root_path="in-memory", exp="BraTS_chip_smoke/UNet3D", model=model, num_classes=2,
        max_iterations=max_iterations, batch_size=TRAIN_BATCH, labeled_bs=LABELED_BS,
        base_lr=0.01, patch_size=(PATCH,) * 3, seed=1337, labeled_num=2, num_tries=tries,
        consis_weight=10.0, val_interval=val_interval, log_interval=1, precision=precision,
        experiments_dir=EXPERIMENTS)


def launches_now(wa) -> dict:
    return {"fwd": dict(wa.window_attention.launches_by_mode),
            "bwd": dict(wa.window_attention_bwd.launches_by_mode)}


def launches_by_route_now(wa) -> dict:
    """The launches so far by route and mode, forward and backward."""
    return {kind: {r: dict(c) for r, c in fn.launches_by_route_mode.items()}
            for kind, fn in (("fwd", wa.window_attention), ("bwd", wa.window_attention_bwd))}


def no_attention(tag: str, path: dict) -> None:
    if any(n for counts in path.values() for n in counts.values()):
        fail(f"{tag} the 3D U-Net path launched window attention: {path}")


def print_log(tag: str, log: list, keys) -> None:
    bad = [(r["iteration"], k) for r in log for k in keys if not math.isfinite(r[k])]
    if bad:
        fail(f"{tag} non-finite loss terms {bad}")
    for r in log:
        print(f"{tag} step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in keys), flush=True)


def phase_training_unet3d(torch, wa, cases, held_out) -> dict:
    """21: Trainer.fit of U-Net-ICL 3D on BraTS at full width, its batches
    made on a Prefetcher thread, then one bf16 step; no window attention."""
    import gc

    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.data.pipeline import Prefetcher
    from icl_tpu_torch.scripts.time_fit import timed
    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, brats_evaluator

    cfg = unet3d_config("unet_3D_icl", "float32", TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # dropout and drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    validate = brats_evaluator(held_out, 2, cfg.patch_size, trainer.device)
    waits = []

    def batches():
        return brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size,
                                   seed=cfg.seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Prefetcher(batches(), pin_memory=trainer.device.type == "cuda") as prefetched:
        wa.reset_launch_counts()
        result = trainer.fit(timed(prefetched, waits), evaluate=validate, class_names=["WT"])
        torch.cuda.synchronize()
        drop_states(result)
        path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged U-Net-ICL 3D steps and a validation, got {result}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    print(f"[unet3d] U-Net-ICL 3D, {n_params} params, built and initialised in {build_s:.2f} s; "
          f"BraTS {PATCH}^3, batch {TRAIN_BATCH} ({LABELED_BS} labeled), 2 classes, f32, TF32 off: "
          f"{s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start); the step's thread waited "
          f"{[round(w, 4) for w in waits]} s for its batches (Prefetcher); peak memory "
          f"{peak / 2**30:.2f} GiB; window-attention launches {path}", flush=True)
    print_log("[unet3d]", log, METRIC_KEYS)
    val = result["vals"][-1]
    print(f"[unet3d] validation at step {val['iteration']} on one held-out {CASE_SIZE}^3 case in "
          f"{val['seconds']:.4f} s: mean dice {val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best "
          f"checkpoint {result['best_path']}", flush=True)
    no_attention("[unet3d]", path)
    if result["best_path"] is None:
        fail(f"U-Net-ICL 3D validation dice {val['mean_dice']}: no best checkpoint was saved")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    trainer = Trainer(unet3d_config("unet_3D_icl", "bfloat16", 1, 0, "bfloat16"), device=DEVICE)
    log16 = [dict(zip(METRIC_KEYS, trainer.train_step(trainer.to_device(next(batches()))).tolist()))]
    print("[unet3d] one bfloat16 autocast step: "
          + " ".join(f"{k} {log16[0][k]:.6f}" for k in METRIC_KEYS), flush=True)
    if not all(math.isfinite(log16[0][k]) for k in METRIC_KEYS):
        fail("non-finite U-Net-ICL 3D loss under bfloat16")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "waits_s": waits, "val_s": val["seconds"],
            "build_s": build_s, "n_params": n_params, "peak_bytes": peak, "path_launches": path,
            "val_dice": val["mean_dice"], "best_path": result["best_path"]}


def phase_unet3d_device_vs_cpu(torch, cases) -> None:
    """22: one U-Net-ICL 3D step at 32^3 on the card against the CPU."""
    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.models.registry import net_factory

    patch = (UNET3D_CPU,) * 3
    batch = next(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, patch, seed=1337))
    starts = []

    def run(device, scale=1.0):
        model = net_factory("unet_3D_icl", 1, 2, device=device, patch_size=UNET3D_CPU,
                            zero_stochastic=True, generator=torch.Generator().manual_seed(1337))
        starts.append({n: p.detach().cpu().clone() for n, p in model.named_parameters()})
        metrics, after = unet_step(torch, model, batch, patch, device, scale, classes=2,
                                   labeled=LABELED_BS, consis=10.0)
        return metrics, {n: t.cpu().clone() for n, t in after.items()}

    t0 = time.perf_counter()
    runs = {"test": run(DEVICE), "reference": run("cpu"), "control": run(DEVICE, 1.0 + 1e-7)}
    if not all(torch.equal(s[n], starts[0][n]) for s in starts for n in starts[0]):
        fail("[unet3d-cpu] the steps did not start from the same weights")
    step_agreement(torch, "[unet3d-cpu]", f"one {UNET3D_CPU}^3 f32 step, card vs CPU "
                   f"({time.perf_counter() - t0:.1f} s for the three)", starts[0], runs)


def phase_supervised_unet3d(torch, wa, cases) -> dict:
    """23: two steps of the supervised U-Net 3D on BraTS through fit."""
    import gc

    from icl_tpu_torch.data.brats import brats_supervised_batches
    from icl_tpu_torch.data.pipeline import Prefetcher
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer

    cfg = unet3d_config("unet_3D", "float32", 2, 0, "supervised")
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Prefetcher(brats_supervised_batches(cases, TRAIN_BATCH, cfg.patch_size, seed=cfg.seed),
                    pin_memory=trainer.device.type == "cuda") as batches:
        wa.reset_launch_counts()
        result = trainer.fit(batches)
        torch.cuda.synchronize()
        drop_states(result)
        log = result["log"]
        path = launches_now(wa)
    print(f"[unet3d-sup] supervised U-Net 3D, BraTS {PATCH}^3, batch {TRAIN_BATCH}, f32: step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; window-attention launches {path}",
          flush=True)
    if len(log) != 2:
        fail(f"expected 2 logged supervised steps, got {log}")
    print_log("[unet3d-sup]", log, SUPERVISED_METRIC_KEYS)
    no_attention("[unet3d-sup]", path)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"path_launches": path, "log": log}


def amos_cli(torch, wa, module: str, argv: list, keys) -> dict:
    """One AMOS training CLI's `main(argv)` from AMOS_ROOT, with the
    window-attention counts and the peak memory of the run."""
    import gc
    import importlib

    cli = importlib.import_module(f"icl_tpu_torch.scripts.{module}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    drop_states(result)
    path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log = result["log"]
    tag = f"[{module}]"
    steps = len(log)
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (steps - 1)
    print(f"{tag} {steps} steps: {s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start, the first waiting for the "
          f"cases' preprocessing); whole run {run_s:.2f} s; peak memory {peak / 2**30:.2f} GiB; "
          f"window-attention launches {path}", flush=True)
    print_log(tag, log, keys)
    for val in result["vals"]:
        print(f"{tag} validation at step {val['iteration']} in {val['seconds']:.4f} s: mean dice "
              f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint "
              f"{result['best_path']}", flush=True)
    no_attention(tag, path)
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": path,
            "vals": result["vals"], "best_path": result["best_path"], "log": log}


def phase_amos(torch, wa) -> tuple[dict, dict]:
    """25 - 27: the AMOS ICL CLI for 3 steps and a validation, the
    supervised CLI for 2 steps, then test_3D_AMOS on the stripped best
    checkpoint, all on a seeded synthetic NIfTI tree."""
    from icl_tpu_torch.data.synth import make_synthetic_amos
    from icl_tpu_torch.scripts import test_3D_AMOS
    from icl_tpu_torch.train.steps import METRIC_KEYS, SUPERVISED_METRIC_KEYS

    shutil.rmtree(AMOS_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    jpath = make_synthetic_amos(AMOS_ROOT, AMOS_CASES, AMOS_SHAPE, AMOS_SPACING, seed=0)
    print(f"[amos] synthetic tree of {AMOS_CASES} cases {AMOS_SHAPE} at spacing {AMOS_SPACING} "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)
    common = ["--root_path", AMOS_ROOT, "--split_path", jpath, "--val_num", "1"]
    cwd = os.getcwd()
    os.chdir(AMOS_ROOT)  # the CLIs' snapshots land in ../experiments
    try:
        torch.manual_seed(0)
        icl = amos_cli(torch, wa, "train_inherent_consistent_unet_3D_AMOS22",
                       common + ["--exp", "AMOS_chip_smoke/ICL", "--labeled_num", "2",
                                 "--total_num", str(AMOS_CASES - 1), "--max_iterations",
                                 str(TRAIN_STEPS), "--val_interval", str(TRAIN_STEPS),
                                 "--num_tries", "bfloat16"], METRIC_KEYS)
        if len(icl["log"]) != TRAIN_STEPS or not icl["vals"] or icl["best_path"] is None:
            fail(f"[amos] expected {TRAIN_STEPS} steps, a validation and a best checkpoint")
        sup = amos_cli(torch, wa, "train_fully_supervised_unet_3D_AMOS22",
                       common + ["--exp", "AMOS_chip_smoke/Fully_Supervised", "--labeled_num",
                                 str(AMOS_CASES - 1), "--max_iterations", "2", "--val_interval",
                                 "0", "--num_tries", "float32"], SUPERVISED_METRIC_KEYS)
        if len(sup["log"]) != 2:
            fail(f"[amos] expected 2 supervised steps, got {sup['log']}")
        total = test_3D_AMOS.main(common[:4] + ["--exp", "AMOS_chip_smoke/ICL", "--labeled_num",
                                                "2", "--num_tries", "bfloat16", "--val_num", "0"])
    finally:
        os.chdir(cwd)
    val_dice = icl["vals"][-1]["mean_dice"]
    print(f"[eval-amos] test_3D_AMOS on the stripped best checkpoint, loaded strictly into UNet3D: "
          f"mean dice {float(total[0])!r}, the trainer's validation {val_dice!r}", flush=True)
    if total[0] != val_dice:
        fail("the AMOS eval CLI does not reproduce the trainer's validation dice")
    return icl, sup


def phase_train_to_eval_unet3d(torch, held_out, training: dict) -> None:
    """24: the BraTS stripped best checkpoint through test_3D_BraTS's loader
    with --model unet_3D_icl."""
    from icl_tpu_torch.eval.infer3d import evaluate_brats_cases, make_patch_predictor
    from icl_tpu_torch.metrics import aggregate_case_metrics
    from icl_tpu_torch.scripts.test_3D_BraTS import load_eval_model

    model = load_eval_model("unet_3D_icl", training["best_path"], 2, DEVICE)
    metric_cal = evaluate_brats_cases(make_patch_predictor(model), held_out, 2, (PATCH,) * 3, STRIDE,
                                      STRIDE, sw_batch=SW_BATCH, device=DEVICE)
    agg = aggregate_case_metrics(metric_cal)
    print(f"[eval-unet3d] stripped best checkpoint, loaded strictly into {type(model).__name__}: "
          f"mean dice {agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}",
          flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the 3D U-Net eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


# A depth cut for the 1200 s limit: on a slow host (Intel family 6 model
# 143) the whole script took 1262.2 s, 180 s of it writing train states at
# ~0.7 GB/s, most of them deleted unread. These phases' `fit`s gather their
# final train state and record its size, but write it to no file (as do
# the second half of 32 and rank 0 of 42's CLI, whose states are compared
# in memory: phases 59-60 took their ~55 s); the write is exercised where a
# phase reads a state back (32, 35, 45, 52; 39 restores a rolling step file).
UNWRITTEN_FINAL_STATES = {"phase_training", "phase_training_2d", "phase_training_unet", "phase_training_unet3d",
                          "phase_supervised_unet3d", "phase_amos", "phase_grad_accum", "phase_fs24_cli",
                          "phase_fs192_cli", "phase_fs240_cli", "phase_fast_cli", "phase_dispatch_and_resume",
                          "phase_swinunet_d192_cli"}


@contextlib.contextmanager
def final_state_not_written(tag: str, names=("last",)):
    """`fit`'s final `state_last.pt` (and the states of `names`) gathered
    but not written while inside (other rolling step files are written as
    ever); one line a skipped write."""
    from icl_tpu_torch.utils import checkpoint as ckpt

    write = ckpt.save_train_state

    def gathered(snapshot_path, state, name="last"):
        if name not in names:
            return write(snapshot_path, state, name)
        print(f"[depth] {tag}: the train state {name} ({ckpt.state_bytes(state) / 1e9:.2f} GB) gathered, "
              "not written", flush=True)
        return ckpt.state_path(snapshot_path, name)

    ckpt.save_train_state = gathered
    try:
        yield
    finally:
        ckpt.save_train_state = write


def drop_states(result: dict) -> None:
    """Delete the train states a `fit` wrote (several GB each for the ICL
    models); the best checkpoints stay for the train -> eval phases."""
    for save in result.get("saves", []):
        if os.path.exists(save["path"]):
            os.remove(save["path"])


def phase_kernels_supervised(torch, F, wa) -> dict:
    """28: the kernels at the supervised paths' shapes, against their
    plain versions and timed beside the bound, the plain version and SDPA:
    Swin-UNet at 224^2 / window 7, batch 16, f32 (stages 1-4, forward and
    backward, with the shift mask and without); SwinUNETR at batch 4 in
    bf16 (stages 1-4, forward and backward, with region ids and without;
    the bound at the bf16 rate and 2-byte q, k, v)."""
    gen = torch.Generator(device=DEVICE).manual_seed(28)
    rows = {"fwd2d": [], "bwd2d": [], "fwd3d": [], "bwd3d": []}
    for stage in STAGES_SWIN_SUP:
        for mode in stage[4]:
            row, brow = check_2d(torch, F, wa, stage, mode, None if mode == "none" else "shift",
                                 torch.float32, gen, batch=BATCH_SWIN_SUP, tag="-sup2d")
            rows["fwd2d"].append(row)
            rows["bwd2d"].append(brow)
    scale = HEAD_DIM ** -0.5
    for stage in STAGES:
        name = stage[0]
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            q, k, v, bias, ids = stage_inputs(torch, (name, TRAIN_BATCH) + stage[2:],
                                              torch.bfloat16, gen)
            ids = ids if mode == "region" else None
            B, H, N, D = q.shape
            nW = ids.shape[0] if ids is not None else B
            got = wa.window_attention(q, k, v, bias, ids, scale=scale)
            again = wa.window_attention(q, k, v, bias, ids, scale=scale)
            want = wa.window_attention_plain(q, k, v, bias, ids, scale=scale)
            err = (got.float() - want.float()).abs()
            row = {"stage": name, "mode": mode, "dtype": "bfloat16", "shape": list(q.shape),
                   "nW": ids.shape[0] if ids is not None else None, "max_abs_err": float(err.max()),
                   "bitwise_repeat": torch.equal(got, again)}
            if (not bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
                    or not row["bitwise_repeat"] or not torch.isfinite(got).all()):
                fail(f"bf16 kernel disagrees with plain or is not repeatable: {row}")
            dense = wa.mask_from_region_ids(ids) if ids is not None else None
            if ids is None:
                attn, qs, ks, vs = bias.to(q.dtype), q, k, v
            else:
                attn = (bias[None] + dense[:, None]).to(q.dtype)
                qs, ks, vs = (t.view(B // nW, nW, H, N, D) for t in (q, k, v))
            bf16_bound = dict(elem_bytes=2, flops_rate=BF16_FLOPS)
            mask_floats = ids.numel() if ids is not None else 0
            row.update(
                ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, ids, scale=scale)),
                plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, scale=scale)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=attn, scale=scale)),
                **bound_fields(*bound(B, H, N, D, mask_floats, **bf16_bound)))
            print(f"[kernel-sup3d] {json.dumps(row)}", flush=True)
            rows["fwd3d"].append(row)
            del attn, qs, ks, vs
            g = torch.randn(q.shape, device=DEVICE, generator=gen).to(q.dtype)
            got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)
            again = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)
            want = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale)
            names = ("dq", "dk", "dv", "dbias")
            errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
            tols = {n: BWD_F32_RTOL if n == "dbias" else BWD_BF16_RTOL for n in names}
            brow = {k: row[k] for k in ("stage", "mode", "dtype", "shape", "nW")}
            brow.update(rel_err=errs, tolerance=tols,
                        max_abs_err=max(float((a.float() - b.float()).abs().max())
                                        for a, b in zip(got, want)),
                        bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, again)))
            if (not all(bool(torch.isfinite(a).all()) for a in got) or not brow["bitwise_repeat"]
                    or any(errs[n] > tols[n] for n in names)):
                fail(f"bf16 backward kernel disagrees with plain or is not repeatable: {brow}")
            brow.update(
                ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)),
                plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                    q, k, v, bias, ids, g, scale=scale), reps=3),
                library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, dense, g, scale),
                **bound_fields(*bound(B, H, N, D, mask_floats, backward=True, **bf16_bound)))
            print(f"[bwd-sup3d] {json.dumps(brow)}", flush=True)
            rows["bwd3d"].append(brow)
            del q, k, v, bias, g, got, again, want, dense
            torch.cuda.empty_cache()
    return rows


class InMemoryDataset:
    """The dataset classes' interface (`cls(root, split, num=...)`) over
    in-memory items: the card's machine has no h5py to read the h5 trees.
    "train" gives the training items (the first `num`), any other split
    the held-out ones."""

    def __init__(self, train: list, held_out: list):
        self.train, self.held_out = train, held_out

    def __call__(self, base_dir, split="train", num=None, **_):
        return (self.train[:num] if num is not None else self.train) if split == "train" \
            else self.held_out


def run_cli(torch, wa, cli, argv: list, dataset_attr: str, data: InMemoryDataset,
            tag: str, keys, steps: int, per_step=None, need_best: bool = True) -> dict:
    """`cli.main(argv)` from SUP_ROOT (its snapshot lands in EXPERIMENTS)
    with the CLI's dataset class over in-memory data; s/step, peak memory,
    every loss term, the validation, the best checkpoint; the
    window-attention launches of the steps (snapshotted before the
    validation through the CLI's evaluator) and of the whole run; the
    train states deleted after."""
    import gc

    per_steps = {}
    evaluator_name = "brats_evaluator" if hasattr(cli, "brats_evaluator") else "acdc_evaluator"
    real_evaluator = getattr(cli, evaluator_name)

    def evaluator(*a, **k):
        validate = real_evaluator(*a, **k)

        def evaluate(model):
            per_steps.setdefault("at_validation", launches_now(wa))
            per_steps.setdefault("at_validation_by_route", launches_by_route_now(wa))
            return validate(model)

        return evaluate

    saved = {dataset_attr: getattr(cli, dataset_attr), evaluator_name: real_evaluator}
    setattr(cli, dataset_attr, data)
    setattr(cli, evaluator_name, evaluator)
    os.makedirs(SUP_ROOT, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(SUP_ROOT)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wa.reset_launch_counts()
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        for attr, value in saved.items():
            setattr(cli, attr, value)
    path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    drop_states(result)
    gc.collect()
    torch.cuda.empty_cache()
    log = result["log"]
    if len(log) != steps or not result["vals"] or (need_best and result["best_path"] is None) \
            or not 0.0 <= result["vals"][-1]["mean_dice"] <= 1.0:
        fail(f"{tag} expected {steps} steps, a validation and a best checkpoint, got {result}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    at_val = per_steps["at_validation"]
    print(f"{tag} {steps} steps: {s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start); whole run {run_s:.2f} s; "
          f"peak memory {peak / 2**30:.2f} GiB; window-attention launches over the steps {at_val}, "
          f"whole run {path}; final state save {result['saves'][-1]['bytes'] / 1e9:.2f} GB in "
          f"{result['saves'][-1]['seconds']:.2f} s", flush=True)
    print_log(tag, log, keys)
    val = result["vals"][-1]
    print(f"{tag} validation at step {val['iteration']} in {val['seconds']:.4f} s: mean dice "
          f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint {result['best_path']}",
          flush=True)
    if per_step is not None:
        for kind in ("fwd", "bwd"):
            want = {m: steps * per_step[kind].get(m, 0) for m in ("none", "region", "mask")}
            if at_val[kind] != want:
                fail(f"{tag} {kind} launches over {steps} steps: {at_val[kind]}, expected {want}")
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": at_val,
            "path_launches_by_route_mode": per_steps["at_validation_by_route"], "run_launches": path,
            "val_dice": val["mean_dice"], "val_s": val["seconds"],
            "best_path": result["best_path"], "log": log,
            "saves": [{k: v[k] for k in ("iteration", "bytes", "seconds")} for v in result["saves"]]}


def phase_supervised_unet_2d(torch, wa, slices, volumes) -> dict:
    """29: the supervised U-Net 2D CLI at its defaults (256^2, batch 16,
    f32) for 3 steps and a validation, then test_2D_ACDC --model unet on its
    best checkpoint; no window attention."""
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_fully_supervised_unet_2D_ACDC as cli
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS

    data = InMemoryDataset(slices, volumes)
    common = ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/Fully_Supervised",
              "--num_tries", "unet"]
    torch.manual_seed(0)
    run = run_cli(torch, wa, cli, common + ["--max_iterations", str(TRAIN_STEPS), "--val_interval",
                                            str(TRAIN_STEPS)], "ACDCDataset", data, "[sup-unet]",
                  SUPERVISED_METRIC_KEYS, TRAIN_STEPS)
    no_attention("[sup-unet]", run["run_launches"])
    eval_dice = eval_cli(test_2D_ACDC, common + ["--model", "unet"], "ACDCDataset", data)
    print(f"[eval-sup-unet] test_2D_ACDC --model unet on the best checkpoint: mean dice "
          f"{eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail("test_2D_ACDC does not reproduce the supervised U-Net's validation dice")
    return run


def eval_cli(module, argv: list, dataset_attr: str, data: InMemoryDataset) -> float:
    """`module.main(argv)` (an eval CLI) from SUP_ROOT over in-memory data:
    its mean dice."""
    saved = getattr(module, dataset_attr)
    setattr(module, dataset_attr, data)
    cwd = os.getcwd()
    os.chdir(SUP_ROOT)
    try:
        return float(module.main(argv)[0])
    finally:
        os.chdir(cwd)
        setattr(module, dataset_attr, saved)


def phase_supervised_swinunet_2d(torch, wa, slices, volumes) -> dict:
    """30: the supervised Swin-UNet CLI at its defaults (224^2, window 7,
    batch 16, f32) from a synthetic ImageNet-layout Swin-T checkpoint (a
    seeded model's encoder, a classification head and one key of the wrong
    shape, which must be dropped) for 3 steps and a validation, with the
    launches per step asserted; one step through the kernels against the
    plain attention by phase 15's rule; test_2D_ACDC --model swinunet on the
    best checkpoint."""
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.models.swin2d import WindowAttention
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_fully_supervised_swinunet_2D_ACDC as cli
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS

    donor = net_factory("swinunet", 1, CLASSES_2D, device="cpu",
                        generator=torch.Generator().manual_seed(30))
    encoder = {k[len("swin_unet."):]: v for k, v in donor.state_dict().items()
               if k.startswith(("swin_unet.layers.", "swin_unet.patch_embed.", "swin_unet.norm."))}
    wrong = "layers.2.blocks.0.attn.qkv.weight"
    ckpt = {**encoder, "head.weight": torch.ones(1000, 768), "head.bias": torch.zeros(1000),
            wrong: torch.zeros(5, 7)}
    os.makedirs(SUP_ROOT, exist_ok=True)
    ckpt_path = os.path.join(SUP_ROOT, "swin_tiny_synthetic.pth")
    torch.save({"model": ckpt}, ckpt_path)
    del donor
    loads = []
    real_load = cli.load_pretrained_swinunet

    def load(model, path):
        loads.append(real_load(model, path))
        return loads[-1]

    cli.load_pretrained_swinunet = load
    data = InMemoryDataset(slices, volumes)
    common = ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/Fully_Supervised",
              "--num_tries", "swinunet"]
    per_step = {kind: dict(PER_FORWARD_SWIN_SUP) for kind in ("fwd", "bwd")}
    try:
        torch.manual_seed(0)  # drop-path masks
        run = run_cli(torch, wa, cli, common + ["--max_iterations", str(TRAIN_STEPS),
                                                "--val_interval", str(TRAIN_STEPS),
                                                "--pretrained_ckpt", ckpt_path],
                      "ACDCDataset", data, "[sup-swinunet]", SUPERVISED_METRIC_KEYS, TRAIN_STEPS,
                      per_step)
    finally:
        cli.load_pretrained_swinunet = real_load
    kept, dropped = loads[0]
    reasons = dict(dropped)
    shape_drops = sorted(k for k, r in dropped if r.startswith("shape"))
    print(f"[sup-swinunet] --pretrained_ckpt: {len(kept)} keys loaded, {len(dropped)} dropped, "
          f"for their shape {shape_drops}; the head {[k for k in reasons if k.startswith('head.')]}",
          flush=True)
    if shape_drops != [f"swin_unet.{wrong}", f"swin_unet.layers_up.1.blocks.0.attn.qkv.weight"] \
            or "head.weight" not in reasons or not any(k.startswith("swin_unet.layers_up.") for k in kept):
        fail("[sup-swinunet] the pretrained load did not keep and drop the expected keys")
    chunks = sum(math.ceil(v["image"].shape[0] / 32) for v in volumes)
    val_fwd = {m: run["run_launches"]["fwd"][m] - run["path_launches"]["fwd"][m]
               for m in ("none", "mask")}
    if val_fwd != {m: chunks * n for m, n in PER_FORWARD_SWIN_SUP.items()}:
        fail(f"[sup-swinunet] validation launches {val_fwd} over {chunks} chunks, expected "
             f"{PER_FORWARD_SWIN_SUP} per chunk")
    cfg = ExperimentConfig(root_path="in-memory", exp="ACDC_chip_smoke/SwinSup", model="swinunet",
                           num_classes=CLASSES_2D, max_iterations=1, batch_size=BATCH_SWIN_SUP,
                           base_lr=0.01, patch_size=(IMG_SWIN_SUP,) * 2, seed=1337,
                           val_interval=0, precision="float32", experiments_dir=EXPERIMENTS)
    from icl_tpu_torch.data.pipeline import supervised_batches

    batch = next(supervised_batches(slices, BATCH_SWIN_SUP, cfg.patch_size, seed=cfg.seed))
    blocks = [f"layers.{i}.blocks.{b}" for i in (0, 3) for b in (0, 1)] + ["layers_up.3.blocks.1"]
    watched = [f"swin_unet.{blk}.attn.{t}" for blk in blocks
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]
    per = sum(PER_FORWARD_SWIN_SUP.values())
    step_parity(torch, wa, cfg, batch, watched, WindowAttention, (per, per), "[step-sup2d]")
    eval_dice = eval_cli(test_2D_ACDC, common + ["--model", "swinunet", "--patch_size",
                                                 str(IMG_SWIN_SUP), str(IMG_SWIN_SUP)],
                         "ACDCDataset", data)
    print(f"[eval-sup-swinunet] test_2D_ACDC --model swinunet on the best checkpoint: mean dice "
          f"{eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail("test_2D_ACDC does not reproduce the supervised Swin-UNet's validation dice")
    return run


def phase_supervised_swinunetr_3d(torch, wa, cases, held_out) -> dict:
    """31: the supervised SwinUNETR CLI at its defaults (fs48, 96^3, batch
    4, bf16, recompute on) from a synthetic SSL SwinViT checkpoint in the
    reference layout (`module.swin_vit.`, `mlp.linear1/linear2`) for 3 steps
    and a validation, with the launches per step asserted; test_3D_BraTS
    --model swinunetr on the best checkpoint."""
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.scripts import test_3D_BraTS
    from icl_tpu_torch.scripts import train_fully_supervised_swinunetr_3D_BraTS as cli
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS

    donor = net_factory("swinunetr", 1, 2, device="cpu", feature_size=FEATURE_SIZE,
                        generator=torch.Generator().manual_seed(31))
    ssl = {f"module.swin_vit.{k[len('swinViT.'):]}": v for k, v in donor.state_dict().items()
           if k.startswith("swinViT.")}
    os.makedirs(SUP_ROOT, exist_ok=True)
    ckpt_path = os.path.join(SUP_ROOT, "model_swinvit_synthetic.pt")
    torch.save({"state_dict": ssl, "epoch": 0}, ckpt_path)
    n_params = sum(1 for k, _ in donor.named_parameters() if k.startswith("swinViT."))
    del donor
    loads = []
    real_load = cli.load_pretrained_swinvit

    def load(model, path):
        loads.append(real_load(model, path))
        return loads[-1]

    cli.load_pretrained_swinvit = load
    data = InMemoryDataset(cases, held_out)
    common = ["--root_path", "in-memory-BraTS", "--exp", "BraTS_chip_smoke/Fully_Supervised",
              "--num_tries", "swinunetr", "--labeled_num", str(len(cases))]
    per_step = {"fwd": SUP_3D_FWD_PER_STEP, "bwd": SUP_3D_BWD_PER_STEP}
    try:
        torch.manual_seed(0)  # drop-path masks
        run = run_cli(torch, wa, cli, common + ["--max_iterations", str(TRAIN_STEPS),
                                                "--val_interval", str(TRAIN_STEPS),
                                                "--ssl_ckpt", ckpt_path],
                      "BraTS2019Dataset", data, "[sup-swinunetr]", SUPERVISED_METRIC_KEYS,
                      TRAIN_STEPS, per_step)
    finally:
        cli.load_pretrained_swinvit = real_load
    kept, dropped = loads[0]
    print(f"[sup-swinunetr] --ssl_ckpt: {len(kept)} keys loaded (the encoder has {n_params} "
          f"parameters), {len(dropped)} dropped ({sorted(set(r for _, r in dropped))})", flush=True)
    if len(kept) != n_params:
        fail("[sup-swinunetr] the SSL load did not fill every encoder parameter")
    eval_dice = eval_cli(test_3D_BraTS, common + ["--model", "swinunetr"], "BraTS2019Dataset", data)
    print(f"[eval-sup-swinunetr] test_3D_BraTS --model swinunetr on the best checkpoint: mean dice "
          f"{eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail("test_3D_BraTS does not reproduce the supervised SwinUNETR's validation dice")
    return run


def flat(state: dict) -> dict:
    """A train state (`Trainer.train_state`) as {name: tensor}."""
    out = {f"model/{k}": v for k, v in state["model"].items()}
    out.update({f"momentum/{i}": s["momentum_buffer"]
                for i, s in state["optimizer"]["state"].items()})
    out.update({f"rng/{k}": v for k, v in state["rng"].items() if k != "modules"})
    out.update({f"rng/modules/{k}": v for k, v in state["rng"]["modules"].items()})
    return out


def phase_resume(torch, slices) -> dict:
    """32: resume on the flagship U-Net-ICL 2D at full width. Run A takes 4
    steps (`train_step`, no save); run B, the same Trainer put back to its
    initial state (`load_train_state`), takes 2 through `fit` (its final
    save; phase 39 restores from rolling saves), and a fresh Trainer
    restores `state_last` (every
    parameter, buffer, momentum, the count, the iteration and the RNG
    states equal to run B's bit for bit) and takes A's batches 3-4 with no
    rolling save (its last step's state is `state_last`'s). The
    caller runs the phase under cuDNN's deterministic algorithms: after
    step 4, B must equal A bit for bit (no kernel of the 2D step adds with
    atomics since the linear resizes became matmuls; where B differs, a
    repeat of run A says whether the step or the resume is at fault, and
    the phase fails either way). The train states are deleted after."""
    import copy
    import gc

    from icl_tpu_torch.train.trainer import Trainer

    def config(tries, interval=0):
        cfg = unet_config(RESUME_STEPS, 0, tries)
        cfg.checkpoint_interval = interval
        return cfg

    def run(tries, batches):
        """A fresh Trainer from the seed through `fit`: (trainer, result)."""
        torch.manual_seed(0)  # dropout and drop-path masks
        trainer = Trainer(config(tries), device=DEVICE)
        return trainer, trainer.fit(batches)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    batches = [b for _, b in zip(range(RESUME_STEPS), acdc_batches(slices, config("batches")))]
    torch.manual_seed(0)  # dropout and drop-path masks
    first = Trainer(config("resumeA"), device=DEVICE)
    s0 = copy.deepcopy(first.train_state())  # on the card, the generators' states included
    for batch in batches:  # fit's steps, without its save
        first.train_step(first.to_device(batch))
    state_a = {k: v.clone() for k, v in flat(first.train_state()).items()}  # on the card
    # run B on the same trainer, put back to its initial state
    first.load_train_state(s0)
    first.cfg = config("resumeB")
    del s0
    release()
    result_first = first.fit(batches[:2])
    (last,) = result_first["saves"]
    torch.manual_seed(1)  # the restore must bring back the generators' states
    b = Trainer(config("resumeB"), device=DEVICE)  # no rolling save at step 4: state_last has it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.restore_state()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved, restored = flat(first.train_state()), flat(b.train_state())
    differ = sorted(k for k in saved if k not in restored or saved[k].dtype != restored[k].dtype
                    or not torch.equal(saved[k].to(restored[k].device), restored[k]))
    scalars = {k: (first.train_state()[k], b.train_state()[k]) for k in ("count", "iteration")}
    del first, saved, restored
    release()
    nbytes = last["bytes"]
    print(f"[resume] U-Net-ICL 2D {IMG_UNET}^2, state {nbytes / 1e9:.3f} GB: "
          f"final save {last['seconds']:.2f} s ({nbytes / 1e9 / last['seconds']:.2f} GB/s), "
          f"restore_state {restore_s:.2f} s ({nbytes / 1e9 / restore_s:.2f} GB/s); restored tensors "
          f"that differ from the saved ones: {differ or 'none'}; (count, iteration) saved vs "
          f"restored {scalars}", flush=True)
    if differ or any(x != y for x, y in scalars.values()) or scalars["iteration"][1] != 2:
        fail("[resume] the restored state is not the saved one bit for bit")
    with final_state_not_written("phase_resume (B's last two steps, compared in memory)"):
        result_b = b.fit(batches[2:])
    if [r["iteration"] for r in result_b["log"]] != [3, 4]:
        fail(f"[resume] the resumed run logged {[r['iteration'] for r in result_b['log']]}")
    state_b = flat(b.train_state())

    def differ_from_a(state):
        n = sum(not torch.equal(state_a[k], state[k].to(state_a[k].device)) for k in state_a)
        return "bitwise equal" if not n else f"{n} of {len(state_a)} tensors differ"

    differ_ab = [k for k in state_a if not torch.equal(state_a[k], state_b[k].to(state_a[k].device))]
    del b, state_b
    release()
    for result in (result_first, result_b):
        drop_states(result)
    print(f"[resume] after step {RESUME_STEPS}, A (4 steps) vs B (2 + restore + 2): "
          f"{'bitwise equal' if not differ_ab else f'{len(differ_ab)} of {len(state_a)} tensors differ'}",
          flush=True)
    if differ_ab:  # a repeat of A tells a fault of the resume from one of the step
        again, result_again = run("resumeRepeat", batches)
        print(f"[resume] A vs a repeat of A from the same seed: {differ_from_a(flat(again.train_state()))}",
              flush=True)
        drop_states(result_again)
        fail("[resume] B must equal A bit for bit under cuDNN's deterministic algorithms")
    return {"bytes": nbytes, "final_s": last["seconds"],
            "restore_s": restore_s, "bitwise": not differ_ab}


def cta_snapshot(exp: str, model: str = "unet") -> str:
    """The FixMatch-CTA CLI's snapshot for `--exp exp` from SUP_ROOT (its
    default --labeled_num 7 and --num_tries 1)."""
    return os.path.join(EXPERIMENTS, f"{exp}_7_labeled", f"{model}_exp_1")


def cta_cli(torch, wa, argv: list, data: InMemoryDataset, tag: str, launches=None) -> dict:
    """The FixMatch-CTA CLI's `main(argv)` from SUP_ROOT (at its defaults:
    256^2, batch 16 of which 8 labeled, the U-Net, f32) over in-memory
    slices, the first LABELED_SLICES_2D labeled: s/step after the warm-up
    step, peak memory, every loss term, the mask ratio and proximity per
    step, the window-attention launches of the run (asserted: `launches`,
    {"fwd": {mode: n}, "bwd": ...}, or none)."""
    import gc

    from icl_tpu_torch.scripts import train_fixmatch_cta_2D as cli
    from icl_tpu_torch.train.steps import FIXMATCH_METRIC_KEYS

    saved = {"ACDCDataset": cli.ACDCDataset, "patients_to_slices": cli.patients_to_slices}
    cli.ACDCDataset = data
    cli.patients_to_slices = lambda root, num: LABELED_SLICES_2D
    os.makedirs(SUP_ROOT, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(SUP_ROOT)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wa.reset_launch_counts()
        t0 = time.perf_counter()
        result = cli.main(argv + ["--root_path", "in-memory-ACDC"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        for attr, value in saved.items():
            setattr(cli, attr, value)
    path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log = result["log"]
    # from the start of step 2 to the end of the last step, whose metrics
    # the loop reads after it (the others' are read one step late)
    s_per_step = (log[-1]["seconds"] - log[1]["started"]) / (len(log) - 1)
    print(f"{tag} {len(log)} steps: {s_per_step:.4f} s/step after the warm-up step (steps started "
          f"at {[round(r['started'], 4) for r in log]} s from the start, their metrics read at "
          f"{[round(r['seconds'], 4) for r in log]} s); whole run {run_s:.2f} s; peak memory "
          f"{peak / 2**30:.2f} GiB; window-attention launches {path}", flush=True)
    print_log(tag, log, FIXMATCH_METRIC_KEYS)
    if launches is None:
        no_attention(tag, path)
    elif {k: {m: path[k].get(m, 0) for m in ("none", "region", "mask")} for k in path} != launches:
        fail(f"{tag} the run launched {path}, expected {launches}")
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": path, "log": log,
            "saves": result["saves"], "run_s": run_s}


def moved_bins(path: str) -> tuple[int, int]:
    """(rate bins off 1.0, all bins) of a cta_state.json."""
    with open(path) as f:
        rates = json.load(f)["rates"]
    values = [v for bins in rates.values() for r in bins for v in r]
    return sum(v != 1.0 for v in values), len(values)


def phase_fixmatch_cta(torch, wa, slices, volumes) -> dict:
    """33: the FixMatch-CTA CLI at the JAX CLI's defaults on phase 14's
    slices: 4 steps with --checkpoint_interval 2 --cta_rate_lag 1, then 2
    with --cta_rate_lag 0; the host seconds of one cta_batches batch made
    alone, and of the step alone on a batch made before; the rate bins
    that moved (asserted: some)."""
    import gc

    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.data.pipeline import cta_batches
    from icl_tpu_torch.train.cta import CTATrainer

    data = InMemoryDataset(slices, volumes)
    for exp in (CTA_EXP, CTA_EXP_LAG0):
        shutil.rmtree(os.path.dirname(cta_snapshot(exp)), ignore_errors=True)
    torch.manual_seed(0)
    lag1 = cta_cli(torch, wa, ["--exp", CTA_EXP, "--max_iterations", str(CTA_STEPS),
                               "--checkpoint_interval", "2", "--cta_rate_lag", "1"], data, "[cta]")
    lag0 = cta_cli(torch, wa, ["--exp", CTA_EXP_LAG0, "--max_iterations", "2",
                               "--checkpoint_interval", "2", "--cta_rate_lag", "0"], data, "[cta-lag0]")
    if [r["iteration"] for r in lag1["log"]] != list(range(1, CTA_STEPS + 1)) \
            or [r["iteration"] for r in lag0["log"]] != [1, 2]:
        fail("[cta] the runs did not log their steps")
    moved = {lag: moved_bins(os.path.join(cta_snapshot(exp), "model", "cta_state.json"))
             for lag, exp in (("lag1", CTA_EXP), ("lag0", CTA_EXP_LAG0))}
    print(f"[cta] rate bins moved off 1.0 (of all bins): {moved}", flush=True)
    if not all(n for n, _ in moved.values()):
        fail("[cta] no rate bin moved")

    host, batches = host_batches_both_ways(
        lambda: cta_batches(slices, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, (IMG_UNET, IMG_UNET),
                            CTAugment(seed=1337), seed=1337), CTA_HOST_BATCHES, "[cta]", split=True)
    batch_s, batch = host["native"]["batch_s"], batches[-1]
    # the same from 256 x 216 slices, an ACDC slice size, where each zoom resamples
    # (phase 14's slices are the patch's size): their first 216 columns
    narrow = [{**item, "image": item["image"][:, :CTA_SLICE_WIDTH],
               "label": item["label"][:, :CTA_SLICE_WIDTH]} for item in slices]
    host_narrow, _ = host_batches_both_ways(
        lambda: cta_batches(narrow, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, (IMG_UNET, IMG_UNET),
                            CTAugment(seed=1337), seed=1337), CTA_HOST_BATCHES,
        f"[cta {SLICE_SIZE_2D}x{CTA_SLICE_WIDTH}]", split=True)
    for size, runs in ((f"{SLICE_SIZE_2D}^2", host), (f"{SLICE_SIZE_2D}x{CTA_SLICE_WIDTH}", host_narrow)):
        print(f"[cta] one batch from {size} slices, host seconds by part (CTAugment's ops, the zooms, "
              "the rest): " + "; ".join(f"{way} {json.dumps(runs[way]['split_s_per_batch'])}"
                                         for way in runs), flush=True)
    cfg = ExperimentConfig(root_path="in-memory-ACDC", exp=CTA_EXP, model="unet",
                           num_classes=CLASSES_2D, batch_size=BATCH_2D, labeled_bs=LABELED_2D,
                           patch_size=(IMG_UNET, IMG_UNET), experiments_dir=EXPERIMENTS)
    trainer = CTATrainer(cfg, device=DEVICE)
    on_device = trainer.to_device(batch)
    step_s = []
    for _ in range(CTA_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_fn(on_device)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    print(f"[cta] one cta_batches batch ({BATCH_2D} slices and a probe at {IMG_UNET}^2) made alone "
          f"on the host: {[round(t, 4) for t in batch_s]} s, median "
          f"{sorted(batch_s)[len(batch_s) // 2]:.4f}; the step alone on a batch made before: "
          f"{[round(t, 4) for t in step_s]} s (the first warms up)", flush=True)
    del trainer, on_device
    gc.collect()
    torch.cuda.empty_cache()
    return {"lag1": lag1, "lag0": lag0, "moved": moved, "batch_s": batch_s, "step_s": step_s,
            "host": {f"{SLICE_SIZE_2D}^2": host, f"{SLICE_SIZE_2D}x{CTA_SLICE_WIDTH}": host_narrow},
            "path_launches": {k: {m: lag1["path_launches"][k].get(m, 0)
                                  + lag0["path_launches"][k].get(m, 0)
                                  for m in ("none", "region", "mask")} for k in ("fwd", "bwd")}}


def fixmatch_step(torch, model, batch, device, conf: float, input_scale: float = 1.0):
    """(metrics, parameters after, the separate probe's proximity) of one
    FixMatch-CTA step with the fused probe of `model` (f32 or f64) on
    `batch`, with a fresh optimizer."""
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_fixmatch_cta_step, probe_proximity

    model.zero_grad(set_to_none=True)
    opt = PolySGD(model.parameters(), 0.01, 30000)
    step = make_fixmatch_cta_step(model, opt, CLASSES_2D, LABELED_2D, conf, 1.0)
    dtype = next(model.parameters()).dtype
    on_device = {k: torch.as_tensor(batch[k]).to(device, dtype) * input_scale
                 for k in ("image_weak", "image_strong", "probe_image")}
    on_device.update({k: torch.as_tensor(batch[k]).to(device).long()
                      for k in ("label_aug", "probe_label")})
    metrics = {k: float(v) for k, v in step(on_device).items()}
    separate = float(probe_proximity(model, on_device["probe_image"], on_device["probe_label"]))
    return metrics, {n: p.detach() for n, p in model.named_parameters()}, separate


def phase_fixmatch_device_vs_cpu(torch, slices) -> None:
    """34: one FixMatch-CTA step at 64^2 on the card against the CPU (same
    weights and batch, dropout off) over the loss terms and every
    parameter: in f64 beside a control step by the rule of 18; in f32
    against the CPU's f64 step, with the CPU's f32 step as the witness of
    f32 rounding (STEP_WITNESS_FACTOR). The same mask on every step, at a
    threshold clear of every confidence; the fused proximity against a
    separate probe forward on the card."""
    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.data.pipeline import cta_batches
    from icl_tpu_torch.models.layers import Dropout
    from icl_tpu_torch.models.registry import net_factory

    side = IMG_UNET_CPU
    batch = next(cta_batches(slices, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, (side, side),
                             CTAugment(seed=1337), seed=1337))

    def build(device, dtype):
        model = net_factory("unet", 1, CLASSES_2D, device=device,
                            generator=torch.Generator().manual_seed(1337)).to(dtype)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        return model

    # the threshold: the middle of the widest gap between the confidences of
    # the first weak pass (f64, on the CPU) from their 30th to their 70th
    # percentile, so that about half the pixels are kept and none lies
    # within rounding of it on either device (one pixel across it moves the
    # unsupervised gradient more than any rounding does)
    with torch.no_grad():
        logits = build("cpu", torch.float64)(torch.as_tensor(batch["image_weak"]).double())
    confs = torch.softmax(logits[LABELED_2D:], 1).amax(1).flatten().sort().values
    lo, hi = int(0.3 * len(confs)), int(0.7 * len(confs))
    gaps = confs[lo + 1:hi] - confs[lo:hi - 1]
    widest = int(gaps.argmax())
    conf = float((confs[lo + widest] + confs[lo + widest + 1]) / 2)
    pixels = (BATCH_2D - LABELED_2D) * side * side
    f32, f64 = torch.float32, torch.float64
    starts, runs, separate = {}, {}, {}
    t0 = time.perf_counter()
    for name, device, dtype, scale in (("f64 test", DEVICE, f64, 1.0), ("f64 reference", "cpu", f64, 1.0),
                                       ("f64 control", DEVICE, f64, 1.0 + 1e-7),
                                       ("f32 test", DEVICE, f32, 1.0), ("f32 witness", "cpu", f32, 1.0)):
        model = build(device, dtype)
        starts[name] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        metrics, after, separate[name] = fixmatch_step(torch, model, batch, device, conf, scale)
        runs[name] = (metrics, {n: t.cpu().clone() for n, t in after.items()})
    first = starts["f64 test"]
    if not all(torch.equal(s[n].double(), first[n]) for s in starts.values() for n in first):
        fail("[cta-cpu] the steps did not start from the same weights")
    masks = {k: r[0]["mask_ratio"] for k, r in runs.items()}
    fused = {k: runs[k][0]["probe_proximity"] for k in ("f64 test", "f32 test")}
    print(f"[cta-cpu] threshold {conf:.7f}, {float(gaps[widest]) / 2:.2e} from the nearest "
          f"confidence: mask ratios {masks} of {pixels} pixels; fused probe proximity on the card "
          f"{fused}, a separate probe forward {({k: separate[k] for k in fused})} (tolerance "
          f"{CTA_PROXIMITY_ATOL}); the five steps in {time.perf_counter() - t0:.1f} s", flush=True)
    if not 0.0 < masks["f64 test"] < 1.0 or len(set(masks.values())) != 1:
        fail("[cta-cpu] the mask is empty or full, or the steps' masks part")
    if any(abs(fused[k] - separate[k]) > CTA_PROXIMITY_ATOL for k in fused):
        fail("[cta-cpu] the fused probe disagrees with a separate probe forward")
    step_agreement(torch, "[cta-cpu]", f"one {side}^2 f64 FixMatch-CTA step, card vs CPU",
                   first, {"test": runs["f64 test"], "reference": runs["f64 reference"],
                           "control": runs["f64 control"]})
    step_agreement(torch, "[cta-cpu]", f"one {side}^2 f32 FixMatch-CTA step on the card vs the "
                   f"CPU's f64 step (witness: the CPU's f32 step)", starts["f32 test"],
                   {"test": runs["f32 test"], "reference": runs["f64 reference"],
                    "witness": runs["f32 witness"]})


def phase_fixmatch_resume(torch, wa, slices, volumes, cta: dict) -> dict:
    """35: a fresh CTATrainer restores phase 33's rate-lag-1 save at step
    CTA_STEPS (state_last and cta_state.json): the restored state equals
    the saved one bit for bit, the rates the saved JSON; then the CLI's
    --resume takes 2 more steps (iterations 5, 6, the rolling save
    step_00000006, then state_last)."""
    import gc

    import numpy as np

    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.train.cta import CTATrainer
    from icl_tpu_torch.utils import checkpoint as ckpt
    from icl_tpu_torch.utils.checkpoint import host_copy

    snapshot = cta_snapshot(CTA_EXP)
    cfg = ExperimentConfig(root_path="in-memory-ACDC", exp=CTA_EXP, model="unet",
                           num_classes=CLASSES_2D, max_iterations=CTA_STEPS + 2,
                           batch_size=BATCH_2D, labeled_bs=LABELED_2D,
                           patch_size=(IMG_UNET, IMG_UNET), labeled_num=7, num_tries="1",
                           checkpoint_interval=2, experiments_dir=EXPERIMENTS)
    if cfg.snapshot_path != snapshot:
        fail(f"[cta-resume] snapshot {cfg.snapshot_path} is not the CLI's {snapshot}")
    trainer = CTATrainer(cfg, device=DEVICE)
    t0 = time.perf_counter()
    iteration = trainer.restore_state()
    restore_s = time.perf_counter() - t0
    saved = flat(ckpt.load_train_state(snapshot, "last", "cpu"))
    restored = flat(host_copy(trainer.train_state()))
    differ = sorted(k for k in saved if k not in restored or saved[k].dtype != restored[k].dtype
                    or not torch.equal(saved[k], restored[k]))
    learner = CTAugment(seed=0)
    CTATrainer.restore_cta(snapshot, learner)
    with open(os.path.join(snapshot, "model", "cta_state.json")) as f:
        want = json.load(f)["rates"]
    rate_diff = [k for k, bins in want.items()
                 if not all(np.array_equal(np.asarray(r, np.float32), got)
                            for r, got in zip(bins, learner.rates[k]))]
    print(f"[cta-resume] restore_state at iteration {iteration} in {restore_s:.3f} s: restored "
          f"tensors that differ from the saved ones: {differ or 'none'} (of {len(saved)}); ops whose "
          f"restored rates differ from cta_state.json: {rate_diff or 'none'}", flush=True)
    if iteration != CTA_STEPS or differ or rate_diff or len(restored) != len(saved):
        fail("[cta-resume] the restored state or rates are not the saved ones")
    del trainer
    gc.collect()
    run = cta_cli(torch, wa, ["--exp", CTA_EXP, "--max_iterations", str(CTA_STEPS + 2),
                              "--checkpoint_interval", "2", "--cta_rate_lag", "1", "--resume"],
                  InMemoryDataset(slices, volumes), "[cta-resume]")
    its = [r["iteration"] for r in run["log"]]
    names = [os.path.basename(s["path"]) for s in run["saves"]]
    print(f"[cta-resume] the resumed run logged iterations {its} and saved {names}", flush=True)
    if its != [CTA_STEPS + 1, CTA_STEPS + 2] \
            or names != [f"state_step_{CTA_STEPS + 2:08d}.pt", "state_last.pt"]:
        fail("[cta-resume] the resumed run did not continue from its step")
    for result in (cta["lag1"], cta["lag0"], run):
        drop_states(result)
    return {"restore_s": restore_s, "iterations": its, "saves": names}


# This slice: the flagship's fast configuration, the JAX CLI's
# `--fuse_icl_pair --precision bfloat16 --state_dtype bfloat16 --input_mode
# device_bank --scan_steps 4 --dispatch_depth 2` (bench.py's
# icl_unet_acdc_fast): U-Net-ICL 2D at 256^2, batch 16 of which 8 labeled,
# on phase 14's slices held on the card; its SGD update the stochastic-
# rounding kernel, one launch per parameter leaf.
FAST_ARGV = ["--fuse_icl_pair", "--precision", "bfloat16", "--state_dtype", "bfloat16",
             "--input_mode", "device_bank", "--scan_steps", "4", "--dispatch_depth", "2"]
# the fast CLI's rolling save at its last step only (a depth cut: the
# states at 4 and 8 were written unread; 39 restores a step-4 file)
FAST_STEPS, FAST_CHECKPOINT = 8, 8
GRAPH_STEPS = 4
# the SR kernel's shapes: the flagship's largest leaf (`mlp2`, 16384^2), a
# small leaf, a ragged length, and the ragged length at an address that is
# not 16-byte aligned (the kernel's scalar path)
SGD_SHAPES = {"mlp2_16384x16384": (268_435_456, 0), "small_4096": (4096, 0),
              "ragged_1000003": (1_000_003, 0), "ragged_unaligned": (1_000_003, 1)}
SGD_REPLACES = "icl_tpu/train/optim.py:_sgd_bf16_state (XLA)"
# The window-attention launches of one supervised Swin-UNet step (224^2,
# window 7, batch 16): 8 no-mask + 6 mask, forward and backward.
SWIN_SUP_PER_STEP = {"none": 8, "mask": 6}


CARD_TEST_FILES = ["tests/test_torch_window_attention_card.py", "tests/test_torch_sgd_bf16_card.py"]


# The card tests in two pytest processes side by side, the two -k
# selections splitting both files' cases between them (884 and 861 of
# 1745; the SR file's and the streamed kernels' go with the first): one
# process took about as long as phase 39 beside it
CARD_TEST_SPLIT = ("not (wide or tile64 or backward)", "wide or tile64 or backward")


def start_card_tests() -> list:
    """The card's kernel tests (JAX-free, without tests/conftest.py), both
    files in two pytest processes (CARD_TEST_SPLIT), started beside the
    phases that time nothing (`run_card_tests` reads them)."""
    procs = []
    for select in CARD_TEST_SPLIT:
        procs.append(subprocess.Popen([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                                       "-q", "-rs", "-m", "cuda", "-k", select, *CARD_TEST_FILES], cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        STARTED.append(procs[-1])
    return procs


def run_card_tests(procs: list) -> dict:
    """The card tests' summaries: fatal on any failure or skip."""
    tails = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            fail("[card-tests] the card's kernel tests outlived 900 s")
        tail = out.strip().splitlines()[-1] if out.strip() else err[-2000:]
        print(f"[card-tests] -k {proc.args[proc.args.index('-k') + 1]!r}: {tail}", flush=True)
        if proc.returncode != 0 or "skipped" in tail or "passed" not in tail:
            print(out[-6000:], err[-3000:], flush=True)
            fail("[card-tests] the card's kernel tests did not all pass")
        tails.append(tail)
    return {"summary": tails}


def fast_config(tries: str, max_iterations: int, **kw):
    """The flagship's fast configuration as an ExperimentConfig (the CLI's
    FAST_ARGV); `kw` sets its fields."""
    cfg = unet_config(max_iterations, 0, tries)
    cfg.precision, cfg.state_dtype, cfg.fuse_icl_pair = "bfloat16", "bfloat16", True
    cfg.device_augment, cfg.scan_steps, cfg.dispatch_depth = True, 4, 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def fast_batches(torch, slices, cfg, n: int) -> list:
    """The first n bank batches of the flagship CLI's device_bank branch
    (the bank of `slices` on the card, the two-stream indices, the draws)."""
    from icl_tpu_torch.data.device_bank import bank_batches, build_acdc_bank, two_stream_index_batches

    image_bank, label_bank = build_acdc_bank(slices, int(cfg.patch_size[0]), DEVICE)
    indices = two_stream_index_batches(LABELED_SLICES_2D, len(slices), cfg.batch_size,
                                       cfg.labeled_bs, seed=cfg.seed)
    stream = bank_batches(image_bank, label_bank, indices, seed=cfg.seed)
    return [next(stream) for _ in range(n)]


def phase_sgd_kernel(torch, sg) -> dict:
    """36: the SR kernel against its plain version, bit for bit, and bitwise
    across two runs, at SGD_SHAPES; then over the flagship's 300 leaves
    (1.15 B parameters): the kernel per call (host-issued) and on the device
    alone (queued behind a GPU sleep), beside the bound, the plain version,
    torch.optim.SGD(fused=True) on the same bf16 tensors (round-to-nearest
    stores: the nearest PyTorch call, not the same function) and the f32
    PolySGD step on an f32 state of the same shapes; the largest leaf alone
    (`mlp2`, 16384^2) beside its bound, plain version and fused SGD."""
    import gc

    from icl_tpu_torch.models.unet2d_icl import UNetICL
    from icl_tpu_torch.train.optim import PolySGD

    gen = torch.Generator(device=DEVICE).manual_seed(36)
    lr = torch.tensor(0.01, device=DEVICE)
    count = torch.tensor(7, dtype=torch.int64, device=DEVICE)

    def draw(n, off=0, scale=1.0):
        return (torch.randn(n + off, generator=gen, device=DEVICE) * scale).to(torch.bfloat16)[off:]

    shapes = {}
    for name, (n, off) in SGD_SHAPES.items():
        p, g, buf = draw(n, off, 0.05), draw(n, off, 0.01), draw(n, off, 0.01)
        runs = []
        for update in (sg.sgd_bf16_update, sg.sgd_bf16_update, sg.sgd_bf16_plain):
            pc, bc = p.clone(), buf.clone()
            update(pc, g, bc, lr, count, 0.9, 1e-4, 0, 3)
            runs.append((pc, bc))
        torch.cuda.synchronize()
        differ = {w: [int((runs[i][j] != runs[2][j]).sum()) for j in (0, 1)]
                  for i, w in ((0, "kernel vs plain"), (1, "repeat vs plain"))}
        repeat = all(torch.equal(runs[0][j], runs[1][j]) for j in (0, 1))
        moved = int((runs[0][0] != p).sum())
        shapes[name] = {"n": n, "aligned": off == 0, "differ_p_buf": differ, "repeat_bitwise": repeat,
                        "p_elements_moved": moved}
        print(f"[sgd] {name}: {json.dumps(shapes[name])}", flush=True)
        if not repeat or any(x for v in differ.values() for x in v) or moved == 0:
            fail(f"[sgd] {name}: the kernel is not its plain version bit for bit")
        del p, g, buf, runs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with torch.device("meta"):  # the flagship's leaf shapes, no weights drawn
        leaves = [p.shape for p in UNetICL(1, CLASSES_2D, patch_size=IMG_UNET,
                                           fuse_sspa_pair=True).parameters()]
    n_params = sum(math.prod(s) for s in leaves)
    ps = [draw(math.prod(s), 0, 0.05).view(s) for s in leaves]
    gs = [draw(math.prod(s), 0, 0.01).view(s) for s in leaves]
    bufs = [draw(math.prod(s), 0, 0.01).view(s) for s in leaves]

    def kernel_step():
        for i, (p, g, b) in enumerate(zip(ps, gs, bufs)):
            sg.sgd_bf16_update(p, g, b, lr, count, 0.9, 1e-4, 0, i)

    def plain_step():
        for i, (p, g, b) in enumerate(zip(ps, gs, bufs)):
            sg.sgd_bf16_plain(p, g, b, lr, count, 0.9, 1e-4, 0, i)

    global QUEUE_BEHIND_SLEEP
    ms = cuda_ms(kernel_step, reps=10)
    QUEUE_BEHIND_SLEEP = True
    try:
        device_ms = cuda_ms(kernel_step, reps=3)
    finally:
        QUEUE_BEHIND_SLEEP = False
    largest = max(range(len(ps)), key=lambda i: ps[i].numel())
    largest_ms = cuda_ms(lambda: sg.sgd_bf16_update(ps[largest], gs[largest], bufs[largest], lr,
                                                    count, 0.9, 1e-4, 0, largest), reps=10)
    plain_ms = cuda_ms(plain_step, reps=1, warmup=0)
    largest_plain_ms = cuda_ms(lambda: sg.sgd_bf16_plain(ps[largest], gs[largest], bufs[largest], lr,
                                                         count, 0.9, 1e-4, 0, largest), reps=1, warmup=0)
    params = [torch.nn.Parameter(p) for p in ps]
    for p, g in zip(params, gs):
        p.grad = g
    fused = torch.optim.SGD(params, lr=0.01, momentum=0.9, weight_decay=1e-4, fused=True)
    library_ms = cuda_ms(fused.step, reps=10)
    fused_leaf = torch.optim.SGD([params[largest]], lr=0.01, momentum=0.9, weight_decay=1e-4, fused=True)
    largest_library_ms = cuda_ms(fused_leaf.step, reps=10)
    del fused, fused_leaf, params, ps, gs, bufs
    gc.collect()
    torch.cuda.empty_cache()
    f32 = [torch.nn.Parameter(torch.randn(s, generator=gen, device=DEVICE) * 0.05) for s in leaves]
    for p in f32:
        p.grad = torch.randn(p.shape, generator=gen, device=DEVICE) * 0.01
    opt32 = PolySGD(f32, 0.01, 30000)
    f32_ms = cuda_ms(opt32.step, reps=3)
    del opt32, f32
    gc.collect()
    torch.cuda.empty_cache()
    byte_ms = 10 * n_params / HBM_BYTES_PER_S * 1e3
    row = {"leaves": len(leaves), "parameters": n_params, "ms": ms, "device_ms": device_ms,
           "largest_leaf_ms": largest_ms, "largest_leaf_bound_ms": 10 * 268_435_456 / HBM_BYTES_PER_S * 1e3,
           "largest_leaf_plain_ms": largest_plain_ms, "largest_leaf_library_ms": largest_library_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "f32_polysgd_ms": f32_ms,
           **bound_fields(0.0, byte_ms), "max_abs_err": 0.0, "shapes": shapes,
           "seconds": time.perf_counter() - t0}
    print(f"[sgd] the flagship's {len(leaves)} leaves ({n_params} parameters, 10 bytes each): "
          f"{json.dumps({k: v for k, v in row.items() if k != 'shapes'})}", flush=True)
    return row


def phase_fast_cli(torch, wa, sg, slices, volumes) -> dict:
    """37: the fast configuration through the flagship CLI's `main` (the
    slices and volumes in memory, the first LABELED_SLICES_2D labeled):
    FAST_STEPS steps, a validation at the last (its dice in [0, 1]; after
    8 steps from random weights it may be 0, and then no best checkpoint is
    written), a checkpoint every FAST_CHECKPOINT; the window-attention launches (asserted: none) and
    the SR launches: the first step runs eagerly and the capture records
    the step once, so the wrapper counts 2 x 300 launches over the run and
    every replayed step runs the 300 the capture recorded (asserted)."""
    from icl_tpu_torch.scripts import train_inherent_consistent_unet_2D as cli
    from icl_tpu_torch.train.steps import METRIC_KEYS

    trainers = []

    class Spy(cli.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)

    saved = {"patients_to_slices": cli.patients_to_slices, "Trainer": cli.Trainer}
    cli.patients_to_slices = lambda root, num: LABELED_SLICES_2D
    cli.Trainer = Spy
    sg.reset_launch_counts()
    torch.manual_seed(0)
    try:
        run = run_cli(torch, wa, cli, ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/Fast",
                                       "--num_tries", "fast", "--max_iterations", str(FAST_STEPS),
                                       "--val_interval", str(FAST_STEPS), "--checkpoint_interval",
                                       str(FAST_CHECKPOINT)] + FAST_ARGV,
                      "ACDCDataset", InMemoryDataset(slices, volumes), "[fast]", METRIC_KEYS, FAST_STEPS,
                      need_best=False)
    finally:
        for attr, value in saved.items():
            setattr(cli, attr, value)
    trainer = trainers[-1]
    leaves = len(trainer.optimizer.params)
    launches = sg.sgd_bf16_update.launches
    saves = [(s["iteration"], s["bytes"]) for s in run["saves"]]
    print(f"[fast] SR launches over the run {launches} (the eager first step and the capture, "
          f"{leaves} leaves each); recorded in the graph, run by each of its {trainer.replays} "
          f"replays: {trainer.graph_launches}; state saves (iteration, bytes) {saves}", flush=True)
    no_attention("[fast]", run["run_launches"])
    if launches != 2 * leaves or trainer.graph_launches["sgd_bf16"] != leaves \
            or trainer.replays != FAST_STEPS - 1 or any(trainer.graph_launches[k]
                                                        for k in ("window_attention",
                                                                  "window_attention_bwd")):
        fail("[fast] the SR launches are not one per leaf per step")
    return {**run, "leaves": leaves, "launches": launches, "per_replay": trainer.graph_launches,
            "replays": trainer.replays, "state_bytes": saves[-1][1]}


def graph_vs_eager(torch, wa, tag: str, trainer, batches: list, deterministic: bool) -> dict:
    """From one state S0 (a copy on the card) of `trainer` (cfg.scan_steps > 1):
    A, GRAPH_STEPS eager steps; a repeat of A; the graph's first step (eager
    on a side stream, then the capture) from S0; then B, GRAPH_STEPS
    replays from S0. The flat states after A, its repeat and B, every step's
    metrics, and s/step eager against replayed (4 more of each from where B
    ended, in turns); the window-attention launches of the graph's first
    step (its eager run and the capture). `deterministic` runs with cuDNN's
    deterministic algorithms."""
    import copy

    dev = [trainer.to_device(b) for b in batches]
    s0 = copy.deepcopy(trainer.train_state())  # every copy on the card: a copy to the host costs seconds
    torch.backends.cudnn.deterministic = deterministic
    try:
        def params():
            return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

        def steps(step):
            """Every step's metrics and the parameters after the first."""
            trainer.load_train_state(s0)
            vecs, after_first = [], None
            for i, x in enumerate(dev):
                vecs.append(step(x))
                if i == 0:
                    after_first = params()
            torch.cuda.synchronize()
            return ({k: v.clone() for k, v in flat(trainer.train_state()).items()},
                    torch.stack(vecs).cpu(), after_first)

        a, a_metrics, a1 = steps(trainer._stacked_step)
        again, again_metrics, again1 = steps(trainer._stacked_step)
        trainer.load_train_state(s0)
        wa.reset_launch_counts()
        trainer.graph_step(dev[0])
        first_step = launches_now(wa)
        b, b_metrics, b1 = steps(trainer.graph_step)

        def run(step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in dev:
                step(x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / len(dev)

        times = {"eager": [], "replayed": []}
        for kind in ("eager", "replayed", "replayed", "eager"):
            times[kind].append(run(trainer._stacked_step if kind == "eager" else trainer.graph_step))
    finally:
        torch.backends.cudnn.deterministic = False
    differ = lambda x: sorted(k for k in a if not torch.equal(a[k], x[k]))
    out = {"s0": {n: s0["model"][n] for n, _ in trainer.model.named_parameters()},
           "first": {"a": a1, "b": b1, "again": again1}, "differ_b": differ(b), "differ_again": differ(again),
           "metrics_equal": torch.equal(a_metrics, b_metrics),
           "again_metrics_equal": torch.equal(a_metrics, again_metrics), "times": times,
           "graph_launches": dict(trainer.graph_launches), "first_step": first_step}
    print(f"{tag} {GRAPH_STEPS} replayed steps vs {GRAPH_STEPS} eager from one state (cuDNN "
          f"deterministic {deterministic}): {len(out['differ_b'])} of {len(a)} tensors differ, "
          f"metrics equal {out['metrics_equal']}; an eager repeat: {len(out['differ_again'])} "
          f"differ, metrics equal {out['again_metrics_equal']}; s/step eager {times['eager']} "
          f"replayed {times['replayed']}; launches recorded in the graph {out['graph_launches']}",
          flush=True)
    return out


def upsample_backward_repeats(torch) -> bool:
    """Whether the backward of the U-Net decoder's align-corners bilinear
    upsample (F.interpolate, here at its largest shape: [16, 16, 128,
    128] to 256^2) is bitwise equal across two runs on the card (its CUDA
    kernel adds with atomics)."""
    import torch.nn.functional as F

    x = torch.randn(16, 16, 128, 128, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(1),
                    requires_grad=True)
    g = torch.randn(16, 16, 256, 256, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(2))
    grads = []
    for _ in range(2):
        x.grad = None
        F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True).backward(g)
        grads.append(x.grad.clone())
    return torch.equal(*grads)


def phase_graph_vs_eager(torch, wa, slices) -> dict:
    """38: graph replay against eager steps. The flagship's fast
    configuration and the supervised Swin-UNet (224^2, window 7, batch 16,
    f32: both window-attention kernels in the graph, their launches per
    replayed step asserted: 8 no-mask + 6 mask, forward and backward) and
    the AMOS bf16 ICL step (U-Net-ICL 3D, 16 classes, recompute on; its
    eager repeat and its replays must be bitwise: autocast's weight cache
    is off in eager steps too, `steps._forward_context`), each by
    `graph_vs_eager` under cuDNN's deterministic algorithms: a replayed
    step must equal the eager one bit for bit wherever an eager repeat is
    bitwise; where the card's own repeat is not, the first replayed step is
    held against the first eager step by the rule of phase 18 with the
    eager repeat as control and witness (the rule "phase 18, control and
    witness = an eager repeat": after one step the card's differences are
    f32 rounding, which the bf16 state's rounding may move by one ulp;
    after four they compound). s/step eager against replayed for the
    three."""
    import gc

    from icl_tpu_torch.scripts.profile_train_step import setup
    from icl_tpu_torch.train.trainer import Trainer

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"upsample_backward_bitwise": upsample_backward_repeats(torch)}
    print(f"[graph] the U-Net decoder's upsample backward twice on the card: bitwise "
          f"{out['upsample_backward_bitwise']}", flush=True)
    cfg = fast_config("graph", 100)
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    fast = graph_vs_eager(torch, wa, "[graph-fast]", trainer, fast_batches(torch, slices, cfg, GRAPH_STEPS),
                          deterministic=True)
    if fast["graph_launches"]["sgd_bf16"] != len(trainer.optimizer.params):
        fail("[graph-fast] the graph does not hold one SR launch per leaf")
    if fast["differ_b"] or not fast["metrics_equal"]:
        if not fast["differ_again"]:
            fail("[graph-fast] the replayed steps differ from the eager ones, which repeat bitwise")
        first = fast["first"]
        step_agreement(torch, "[graph-fast]", "the first replayed step vs the first eager step (rule: "
                       "phase 18, control and witness = an eager repeat)", fast["s0"],
                       {"test": ({}, first["b"]), "reference": ({}, first["a"]),
                        "control": ({}, first["again"]), "witness": ({}, first["again"])})
    out["fast"] = {k: fast[k] for k in ("differ_b", "differ_again", "metrics_equal", "times",
                                        "graph_launches")}
    del trainer, fast
    release()

    cfg, make_batches, _ = setup("swinunet", "float32")
    cfg.scan_steps = GRAPH_STEPS
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    stream = make_batches()
    swin = graph_vs_eager(torch, wa, "[graph-swin]", trainer, [next(stream) for _ in range(GRAPH_STEPS)],
                          deterministic=True)
    per_step = sum(SWIN_SUP_PER_STEP.values())
    if swin["graph_launches"]["window_attention"] != per_step \
            or swin["graph_launches"]["window_attention_bwd"] != per_step:
        fail(f"[graph-swin] the graph holds {swin['graph_launches']}, want {per_step} + {per_step}")
    if swin["differ_b"] or not swin["metrics_equal"]:
        fail(f"[graph-swin] the replayed steps differ from the eager ones: {swin['differ_b'][:8]}")
    out["swin"] = {k: swin[k] for k in ("differ_b", "differ_again", "metrics_equal", "times",
                                        "graph_launches")}
    out["swin_first_step"] = swin["first_step"]
    want = {m: 2 * SWIN_SUP_PER_STEP.get(m, 0) for m in ("none", "region", "mask")}
    if swin["first_step"]["fwd"] != want or swin["first_step"]["bwd"] != want:
        fail(f"[graph-swin] the eager first step and the capture launched {swin['first_step']}, "
             f"want {want} each way")
    del trainer, swin
    release()

    cfg, make_batches, _ = setup("unet_3D_icl", "bfloat16", "amos")
    cfg.scan_steps = GRAPH_STEPS
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    stream = make_batches()
    amos = graph_vs_eager(torch, wa, "[graph-amos]", trainer, [next(stream) for _ in range(3)],
                          deterministic=True)
    if amos["differ_again"] or not amos["again_metrics_equal"]:
        fail(f"[graph-amos] an eager repeat differs: {amos['differ_again'][:8]}")
    if amos["differ_b"] or not amos["metrics_equal"]:
        fail(f"[graph-amos] the replayed steps differ from the eager ones, which repeat bitwise: "
             f"{amos['differ_b'][:8]}")
    first = amos["first"]
    amos["first_differ"] = sorted(k for k in first["a"] if not torch.equal(first["a"][k], first["b"][k]))
    # each differing parameter's largest difference over its largest eager update
    amos["first_rel"] = {k: ratio(float((first["b"][k] - first["a"][k]).abs().max()),
                                  float((first["a"][k] - amos["s0"][k]).abs().max()))
                         for k in amos["first_differ"]}
    print(f"[graph-amos] the first replayed step against the first eager step: "
          f"{len(amos['first_differ'])} of {len(first['a'])} parameters differ, each by at most "
          f"{max(amos['first_rel'].values(), default=0.0):.3e} of its largest update "
          f"{dict(sorted(amos['first_rel'].items(), key=lambda kv: -kv[1])[:5])}", flush=True)
    out["amos"] = {k: amos[k] for k in ("differ_b", "differ_again", "metrics_equal", "times",
                                        "first_differ", "first_rel")}
    del trainer, amos
    release()
    return out


def log_lines(snapshot: str) -> list:
    """log.txt's per-step loss lines, without their time stamps."""
    with open(os.path.join(snapshot, "log.txt")) as f:
        return [line.split("]", 1)[-1] for line in f if "iteration" in line and "loss" in line]


def phase_dispatch_and_resume(torch, slices) -> dict:
    """39: under cuDNN's deterministic algorithms, (a) `fit` of the
    supervised Swin-UNet (224^2, window 7, batch 16, f32) with scan_steps 2
    at dispatch_depth 2 against depth 1: the parameters bit for bit and
    log.txt's loss lines equal; (b) the bf16 train state resumed, 4 + 4
    steps against 8 (scan_steps 4: the 8-step run replays steps 5-8, the
    resumed one runs step 5 eagerly): on the supervised Swin-UNet bit for
    bit; on the flagship's fast configuration bit for bit where an
    8-step repeat is, else by the rule of phase 38. Each model and state
    type is built once: every run starts from its initial state put back
    (`load_train_state`), the resumed one then from the step file, and
    with no captured graph."""
    import copy
    import gc

    from icl_tpu_torch.scripts.profile_train_step import setup
    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils import checkpoint as ckpt

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def swin_cfg(tries, **kw):
        cfg, make_batches, _ = setup("swinunet", "float32")
        cfg.experiments_dir, cfg.exp, cfg.num_tries = EXPERIMENTS, "ACDC_chip_smoke/Dispatch", tries
        cfg.max_iterations, cfg.val_interval = 8, 0
        for k, v in kw.items():
            setattr(cfg, k, v)
        return cfg, make_batches

    built = {}  # (model, state_dtype) -> (Trainer from seed 0, its initial train state)

    def fit(cfg, batches, restore=None):
        """`fit` under `cfg` on the Trainer of cfg's model and state type,
        built once from seed 0, its graphs dropped and its initial state
        put back first (then the step file of another snapshot, when
        `restore` names one): (flat state, result, the parameters before
        the fit)."""
        key = (cfg.model, cfg.state_dtype)
        if key not in built:
            torch.manual_seed(0)
            trainer = Trainer(cfg, device=DEVICE)
            built[key] = (trainer, copy.deepcopy(trainer.train_state()))  # on the card
        trainer, initial = built[key]
        drop_graphs(trainer)
        trainer.load_train_state(initial)
        trainer.cfg = cfg
        if restore is not None:
            trainer.load_train_state(ckpt.load_train_state(*restore, device=DEVICE))
        start = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        # the run's rolling state at step 8 (B restores step 4) and final state: compared in memory
        with final_state_not_written("phase_dispatch_and_resume", names=("last", "step_00000008")):
            result = trainer.fit(batches)
        state = {k: v.clone() for k, v in flat(trainer.train_state()).items()}  # on the card
        return state, result, start

    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for depth in (1, 2):
            cfg, make_batches = swin_cfg(f"depth{depth}", scan_steps=2, dispatch_depth=depth)
            stream = make_batches()
            state, result, _ = fit(cfg, [next(stream) for _ in range(8)])
            drop_states(result)
            runs[depth] = (state, log_lines(cfg.snapshot_path))
        differ = sorted(k for k in runs[1][0] if not torch.equal(runs[1][0][k], runs[2][0][k]))
        print(f"[dispatch] Swin-UNet, 8 steps in groups of 2, depth 2 vs 1: {len(differ)} of "
              f"{len(runs[1][0])} tensors differ; log lines {len(runs[1][1])} and {len(runs[2][1])}, "
              f"equal {runs[1][1] == runs[2][1]}", flush=True)
        if differ or runs[1][1] != runs[2][1] or len(runs[1][1]) != 8:
            fail("[dispatch] dispatch_depth 2 moved the parameters or the logs")
        out["depth"] = {"differ": differ, "log_lines": len(runs[1][1])}

        for tag, kind in (("[resume-swin]", "swin"), ("[resume-fast]", "fast")):
            if kind == "swin":
                cfg_a, make_batches = swin_cfg("resumeA", state_dtype="bfloat16", scan_steps=4,
                                               checkpoint_interval=4)
                stream = make_batches()
                batches = [next(stream) for _ in range(8)]
                cfg_b, _ = swin_cfg("resumeB", state_dtype="bfloat16", scan_steps=4)
                cfg_r, _ = swin_cfg("resumeR", state_dtype="bfloat16", scan_steps=4)
            else:
                cfg_a = fast_config("resumeA", 8, checkpoint_interval=4)
                batches = fast_batches(torch, slices, cfg_a, 8)
                cfg_b = fast_config("resumeB", 8)
                cfg_r = fast_config("resumeR", 8)
            a, result_a, initial = fit(cfg_a, batches)
            # B: the trainer restores A's step-4 file and takes batches 5-8
            # (no rolling save: its step-8 state is state_last's)
            step4 = [s for s in result_a["saves"] if s["iteration"] == 4]
            b, result_b, _ = fit(cfg_b, batches[4:], restore=(cfg_a.snapshot_path, "step_00000004"))
            if not step4 or [r["iteration"] for r in result_b["log"]] != [5, 6, 7, 8]:
                fail(f"{tag} the resumed run did not take steps 5-8")
            differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
            print(f"{tag} bf16 state {step4[0]['bytes'] / 1e9:.3f} GB at step 4; 4 + restore + 4 vs 8: "
                  f"{len(differ)} of {len(a)} tensors differ {differ[:4]}", flush=True)
            out[kind] = {"differ": len(differ), "tensors": len(a), "state_bytes": step4[0]["bytes"]}
            drop_states(result_a)
            drop_states(result_b)
            if not differ:
                continue
            if kind == "swin":
                fail(f"{tag} the resumed bf16 run is not the uninterrupted one bit for bit")
            r, result_r, _ = fit(cfg_r, batches)
            drop_states(result_r)
            differ_r = sorted(k for k in a if not torch.equal(a[k], r[k]))
            print(f"{tag} a repeat of the 8 steps: {len(differ_r)} tensors differ", flush=True)
            if not differ_r:
                fail(f"{tag} the resumed run differs where a repeat of the run does not")
            trained = lambda st: ({}, {n: st[f"model/{n}"] for n in initial})
            step_agreement(torch, tag, "4 + restore + 4 vs 8 bf16 steps (rule: phase 18, "
                           "control and witness = a repeat of the 8 steps)", initial,
                           {"test": trained(b), "reference": trained(a), "control": trained(r),
                            "witness": trained(r)})
            out[kind]["differ_repeat"] = len(differ_r)
    finally:
        torch.backends.cudnn.deterministic = False
    built.clear()
    release()
    return out


def phase_device_augment(torch, slices) -> dict:
    """40: `augment_batch` on the card against the same call on the CPU,
    for the same bank and draws: every angle in [-20, 20), every rot90/flip
    branch and the identity, at the patch (256^2) and zoomed to 224^2; 0
    differing pixels in images and labels. Then the time of one flagship
    batch (16 slices) on the card."""
    import numpy as np

    from icl_tpu_torch.data.device_augment import NONE, ROT_FLIP, ROTATE, augment_batch
    from icl_tpu_torch.data.device_bank import build_acdc_bank

    angles = list(range(-20, 20))
    flips = [(k, axis) for k in range(4) for axis in (0, 1)]
    n = len(angles) + len(flips) + 1
    params = {"branch": np.array([ROTATE] * len(angles) + [ROT_FLIP] * len(flips) + [NONE]),
              "k": np.array([0] * len(angles) + [k for k, _ in flips] + [0]),
              "axis": np.array([0] * len(angles) + [a for _, a in flips] + [0]),
              "angle": np.array(angles + [0] * len(flips) + [0])}
    idx = np.arange(n) % len(slices)
    out = {}
    for device in ("cpu", DEVICE):
        image_bank, label_bank = build_acdc_bank(slices, IMG_UNET, device)
        ix = torch.as_tensor(idx, device=device)
        prm = {k: torch.as_tensor(v, dtype=torch.int64, device=device) for k, v in params.items()}
        for size in (IMG_UNET, 224):
            img, lab = augment_batch(image_bank[ix], label_bank[ix], prm, size)
            out[(device, size)] = (img.cpu(), lab.cpu())
    differ = {size: (int((out[("cpu", size)][0] != out[(DEVICE, size)][0]).sum()),
                     int((out[("cpu", size)][1] != out[(DEVICE, size)][1]).sum())) for size in (IMG_UNET, 224)}
    image_bank, label_bank = build_acdc_bank(slices, IMG_UNET, DEVICE)
    ix = torch.arange(BATCH_2D, device=DEVICE)
    prm = {k: torch.as_tensor(v[:BATCH_2D], dtype=torch.int64, device=DEVICE) for k, v in params.items()}
    ms = cuda_ms(lambda: augment_batch(image_bank[ix], label_bank[ix], prm, IMG_UNET), reps=20)
    print(f"[augment] {n} samples ({len(angles)} angles, {len(flips)} rot90/flip, identity), card vs "
          f"CPU differing (image, label) pixels by output size {differ}; one batch of {BATCH_2D} at "
          f"{IMG_UNET}^2 on the card: {ms:.4f} ms", flush=True)
    if any(a or b for a, b in differ.values()):
        fail("[augment] the card's device augment differs from the CPU's")
    return {"differ": differ, "batch_ms": ms}


def eager_repeat(torch, trainer, batch) -> tuple:
    """One eager step of `trainer` from its state S0 (a copy on the card),
    then the same step again from S0: (names of the tensors of the flat
    train state that differ, plus "metrics" if the metrics do, the count of
    tensors, the first step's metrics, S0 and the device batch)."""
    import copy

    dev = trainer.to_device(batch)
    s0 = copy.deepcopy(trainer.train_state())
    runs = []
    for _ in range(2):
        trainer.load_train_state(s0)
        vec = trainer._stacked_step(dev)
        torch.cuda.synchronize()
        runs.append(({k: v.clone() for k, v in flat(trainer.train_state()).items()}, vec.cpu()))
    (a, ma), (b, mb) = runs
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    if not torch.equal(ma, mb):
        differ.append("metrics")
    return differ, len(a), dict(zip(trainer.metric_keys, ma.tolist())), s0, dev


def phase_3d_repeats(torch) -> dict:
    """41: the 3D steps repeat bit for bit on the card. The 3D U-Net's
    upsample (`resize_linear`, one matmul per axis) against F.interpolate's
    trilinear mode in f32 at the largest decoder shape of a 96^3 pass
    ([2, 32, 48^3] to 96^3); then one BraTS f32 U-Net-ICL 3D step, run twice
    from one state under cuDNN's deterministic algorithms: 0 tensors of the
    train state may differ (the AMOS bf16 ICL step's eager repeat is phase
    38's, under the same algorithms). The BraTS step once more under
    torch.use_deterministic_algorithms(True, warn_only=True): the ops it
    names (they lack a deterministic CUDA kernel; the repeat, not the
    warning, is the judge)."""
    import gc
    import warnings

    import torch.nn.functional as F

    from icl_tpu_torch.models.layers import resize_linear
    from icl_tpu_torch.scripts.profile_train_step import setup
    from icl_tpu_torch.train.trainer import Trainer

    x = torch.randn(2, 32, 48, 48, 48, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(41))
    err = float((resize_linear(x, [96] * 3, align_corners=False)
                 - F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False)).abs().max())
    print(f"[repeat3d] the 3D upsample, matmuls vs F.interpolate trilinear, f32 [2, 32, 48^3] -> "
          f"96^3: max abs diff {err:.3e} (tolerance {F32_ATOL})", flush=True)
    if err > F32_ATOL:
        fail("the 3D upsample disagrees with F.interpolate")
    out = {"upsample_max_abs_diff": err}
    del x
    torch.backends.cudnn.deterministic = True
    try:
        for tag, precision, dataset in (("brats_f32", "float32", "brats"),):
            cfg, make_batches, what = setup("unet_3D_icl", precision, dataset)
            torch.manual_seed(0)  # dropout and drop-path masks
            trainer = Trainer(cfg, device=DEVICE)
            differ, n, metrics, s0, dev = eager_repeat(torch, trainer, next(make_batches()))
            named = []
            if tag == "brats_f32":
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.use_deterministic_algorithms(True, warn_only=True)
                    try:
                        trainer.load_train_state(s0)
                        trainer._stacked_step(dev)
                        torch.cuda.synchronize()
                    finally:
                        torch.use_deterministic_algorithms(False)
                named = sorted({str(w.message).split(" does not have")[0] for w in caught
                                if "deterministic" in str(w.message)})
            print(f"[repeat3d] {what}, {precision}: one step twice from one state (cuDNN "
                  f"deterministic): {len(differ)} of {n} tensors differ {differ[:8]}; loss "
                  f"{metrics['loss']:.6f}; ops named by use_deterministic_algorithms: {named}",
                  flush=True)
            if differ:
                fail(f"[repeat3d] the {tag} step does not repeat bit for bit")
            out[tag] = {"differ": len(differ), "tensors": n, "named_ops": named}
            del trainer, s0, dev
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


# Phases 42-43: data parallelism, 2 ranks on the one card (gloo: NCCL takes
# one rank per card), each rank a process of this script (`--dp-worker`).
DP_ROOT = os.path.join(ROOT, "build", "chip_smoke", "dp")
DP_STEPS, DP_BF16_STEPS = 2, 1
DP_CLI_STEPS = 1  # the CLI's ranks: one step and a validation (the steady step: [dp-numbers])
DP_CLI_ARGV = ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/DP", "--num_tries", "cli",
               "--device", DEVICE]
DP_METRIC_RTOL = 1e-5  # the first step's loss terms, 2 ranks vs 1: f32 sums in another order


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(kind: str, world: int) -> dict:
    """Start `python3 chip_smoke.py --dp-worker kind rank world port out`
    for each rank, together, each logging to DP_ROOT/{kind}_rank{r}.log."""
    os.makedirs(DP_ROOT, exist_ok=True)
    port = free_port()
    run = {"kind": kind, "procs": [],
           "outs": [os.path.join(DP_ROOT, f"{kind}_rank{r}.json") for r in range(world)],
           "logs": [os.path.join(DP_ROOT, f"{kind}_rank{r}.log") for r in range(world)]}
    for r in range(world):
        with open(run["logs"][r], "w") as log:
            run["procs"].append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-worker", kind, str(r), str(world),
                 str(port), run["outs"][r]], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
    STARTED.extend(run["procs"])
    return run


def finish_ranks(run: dict, timeout: float) -> list:
    """Wait for the ranks of `start_ranks`; each rank's JSON result, the
    lines of its log that start with "[" printed after it. A rank that
    exits non-zero or outlives `timeout` fails the phase, every rank killed
    first."""
    procs = run["procs"]
    deadline = time.monotonic() + timeout
    try:
        codes = [p.wait(timeout=max(deadline - time.monotonic(), 1.0)) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, path in enumerate(run["logs"]):
        with open(path) as f:
            lines = f.read().splitlines()
        keep = [line for line in lines if line.startswith("[")]
        if codes is None or codes[r] != 0:
            keep = lines[-40:]
        for line in keep:
            print(f"  rank {r}: {line}", flush=True)
    if codes is None or any(codes):
        fail(f"[dp] the {run['kind']} ranks exited {codes} (None: killed at the {timeout} s limit)")
    results = []
    for o in run["outs"]:
        with open(o) as f:
            results.append(json.load(f))
    return results


def spawn_ranks(kind: str, world: int, timeout: float) -> list:
    """`start_ranks` then `finish_ranks`."""
    return finish_ranks(start_ranks(kind, world), timeout)


def instrument_all_reduce(torch, dist) -> dict:
    """Time every torch.distributed.all_reduce of this process (the port's
    collectives call it through the module): seconds from a synchronised
    card to a synchronised card, calls, bytes."""
    totals = {"seconds": 0.0, "calls": 0, "bytes": 0}
    inner = dist.all_reduce

    def all_reduce(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = inner(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        totals["seconds"] += time.perf_counter() - t0
        totals["calls"] += 1
        totals["bytes"] += tensor.numel() * tensor.element_size()
        return work

    dist.all_reduce = all_reduce
    return totals


def timed_steps(torch, step_fn, totals: dict, steps: list):
    """step_fn, each call timed from a synchronised card to a synchronised
    card, with the all-reduce seconds spent in it (`instrument_all_reduce`)."""

    def step(batch):
        torch.cuda.synchronize()
        t0, ar0 = time.perf_counter(), totals["seconds"]
        out = step_fn(batch)
        torch.cuda.synchronize()
        seconds, ar = time.perf_counter() - t0, totals["seconds"] - ar0
        steps.append({"seconds": seconds, "all_reduce_s": ar, "compute_s": seconds - ar})
        return out

    return step


def state_digest(torch, trainer) -> str:
    """sha256 over the names and the sha256 digests of the bytes of every
    tensor of the model's state_dict and of every momentum buffer, in order
    (the tensors hashed on 4 threads: hashlib releases the GIL)."""
    import hashlib

    tensors = list(trainer.model.state_dict().items())
    tensors += [(f"momentum/{i}", b) for i, b in enumerate(trainer.optimizer.momentum_buffers)]

    def digest(t) -> bytes:
        return hashlib.sha256(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy()).digest()

    with ThreadPoolExecutor(4) as pool:
        digests = list(pool.map(digest, [t for _, t in tensors]))
    h = hashlib.sha256()
    for (name, _), d in zip(tensors, digests):
        h.update(name.encode())
        h.update(d)
    return h.hexdigest()


def float_state(trainer) -> dict:
    """{name: tensor} of the parameters, the floating-point buffers and the
    momentum buffers (live tensors)."""
    out = {f"param/{n}": p.detach() for n, p in trainer.model.named_parameters()}
    out.update({f"buffer/{n}": b for n, b in trainer.model.named_buffers() if b.is_floating_point()})
    out.update({f"momentum/{i}": b for i, b in enumerate(trainer.optimizer.momentum_buffers)})
    return out


def dp_cli_worker(torch, rank: int, world: int, port: int) -> dict:
    """Rank `rank` of the flagship CLI's `main` at its defaults (256^2, batch
    16 of which 8 labeled, f32, dropout on) over phase 14's slices and
    volumes in memory, DP_CLI_STEPS steps and a validation, through
    --dist_coordinator; rank 0 from SUP_ROOT (its snapshot in EXPERIMENTS),
    the others from a directory of their own, which must stay empty. Its
    steps timed, compute and all-reduce apart; peak memory; the digest of
    its final state; its window-attention launches."""
    import torch.distributed as dist

    from icl_tpu_torch.data.synth import synthetic_acdc
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.scripts import train_inherent_consistent_unet_2D as cli
    from icl_tpu_torch.train.trainer import Trainer

    slices, volumes = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D, CLASSES_2D, seed=0)
    cli.ACDCDataset = InMemoryDataset(slices, volumes)
    cli.patients_to_slices = lambda root, num: LABELED_SLICES_2D
    totals = instrument_all_reduce(torch, dist)
    trainers, steps = [], []
    fit = Trainer.fit

    def fit_timed(self, *args, **kwargs):
        trainers.append(self)
        self.step_fn = timed_steps(torch, self.step_fn, totals, steps)
        return fit(self, *args, **kwargs)

    Trainer.fit = fit_timed
    cwd = SUP_ROOT if rank == 0 else os.path.join(DP_ROOT, f"rank{rank}", "cwd")
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    wa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with final_state_not_written(f"phase_data_parallel rank {rank} (its digest is compared)"):
        result = cli.main(DP_CLI_ARGV + ["--max_iterations", str(DP_CLI_STEPS), "--val_interval",
                                         str(DP_CLI_STEPS), "--num_processes", str(world), "--process_id",
                                         str(rank), "--dist_coordinator", f"127.0.0.1:{port}"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"steps": steps, "log": result["log"], "vals": result["vals"],
           "best_path": result["best_path"], "peak_bytes": peak, "all_reduce": dict(totals),
           "digest": state_digest(torch, trainers[0]), "attention": launches_now(wa),
           "saves": [s["path"] for s in result["saves"]]}
    drop_states(result)
    print(f"[dp-cli] rank {rank}: steps {steps}; peak memory {peak / 2**30:.2f} GiB; all-reduce "
          f"{totals}", flush=True)
    return out


def one_process_runs(torch, cfg, batches: list, variants: list):
    """For each of `variants` (keyword dicts), (loss terms of every step by
    "key@step", the float state after, on the host) of one-process steps
    over `batches` from one Trainer's initial state: the images times
    `scale`; with `reverse`, each branch's rows in reverse order; with
    `global_batch_norm`, every train-mode BatchNorm through the
    data-parallel formula (`_GlobalBatchNorm._global_forward`) over the one
    process's rows: each the same steps in exact arithmetic, other ones in
    f32. A generator of states on the card, each a copy of its own (a
    flagship state is 9.2 GB: the caller keeps three or four)."""
    import copy
    import gc

    import numpy as np

    from icl_tpu_torch.models import layers
    from icl_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=DEVICE)
    s0 = copy.deepcopy(trainer.train_state())  # on the card: each run starts with a device copy
    norms = [m for m in trainer.model.modules() if isinstance(m, layers._GlobalBatchNorm)]
    for kw in variants:
        trainer.load_train_state(s0)
        for m in norms:
            if kw.get("global_batch_norm"):
                m.forward = (lambda bn: lambda x: bn._global_forward(x) if bn.training
                             else type(bn).forward(bn, x))(m)
            else:
                m.__dict__.pop("forward", None)
        rows = np.arange(cfg.batch_size)
        if kw.get("reverse"):
            rows = np.concatenate([rows[:cfg.labeled_bs][::-1], rows[cfg.labeled_bs:][::-1]])
        metrics = {}
        for i, b in enumerate(batches):
            vec = trainer.train_step(trainer.to_device(
                {"image": b["image"][rows] * np.float32(kw.get("scale", 1.0)), "label": b["label"][rows]}))
            metrics.update({f"{k}@{i + 1}": v for k, v in zip(trainer.metric_keys, vec.tolist())})
        yield metrics, {k: v.clone() for k, v in float_state(trainer).items()}
    del trainer, s0
    gc.collect()
    torch.cuda.empty_cache()


def dp_numbers_worker(torch, rank: int, world: int, port: int) -> dict:
    """Rank `rank` of the flagship's `Trainer` at full width with
    zero_stochastic, f32, joined through `initialize_from_args`: DP_STEPS
    steps on its rows of phase 17's global batches, then a bf16-state
    Trainer for DP_BF16_STEPS steps; each run's digest, steps timed; cuDNN's
    deterministic algorithms throughout; then the same steps over tp=2 on
    the global batches (`tp_flagship_steps`). Rank 0 then leaves the group
    and holds its f32 state, and the tp=2 state, against a one-process
    Trainer on the global batches
    (`step_agreement` over the parameters, floating-point buffers and
    momentum), with a control run on the images times 1 + 1e-7, and as the
    witness, per tensor, the farthest from the reference of four one-process
    runs that compute the same steps in exact arithmetic and other ones in
    f32 (the images times 1 - 1e-7; each branch's rows reversed; the
    data-parallel BatchNorm formula; both): the 2 ranks differ from 1
    process by f32 arithmetic of these kinds (the BatchNorm formula, the
    order of the sums over the batch), and the gradients of the ICL heads'
    `mlp2`, behind BatchNorms of near-constant attention maps at random
    weights, move by tens of fixed allowances under any of them after 3
    steps."""
    import dataclasses
    import gc

    import torch.distributed as dist

    from icl_tpu_torch.data.synth import synthetic_acdc
    from icl_tpu_torch.ops import sgd_bf16 as sg
    from icl_tpu_torch.parallel.collectives import barrier
    from icl_tpu_torch.parallel.mesh import world_group
    from icl_tpu_torch.parallel.multihost import host_slice, initialize_from_args
    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils.checkpoint import host_copy

    initialize_from_args(f"127.0.0.1:{port}", world, rank, device=DEVICE, rows=(BATCH_2D, LABELED_2D))
    torch.backends.cudnn.deterministic = True
    totals = instrument_all_reduce(torch, dist)
    slices, _ = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D, CLASSES_2D, seed=0)
    cfg = unet_config(30000, 0, "dp", zero_stochastic=True)
    batches = [b for _, b in zip(range(DP_STEPS), acdc_batches(slices, cfg))]
    out = {}
    for kind, run_cfg, n in (("f32", cfg, DP_STEPS),
                             ("bf16", dataclasses.replace(cfg, state_dtype="bfloat16"), DP_BF16_STEPS)):
        trainer = Trainer(run_cfg, device=DEVICE)
        if kind == "f32" and rank == 0:
            before = host_copy(float_state(trainer))
        steps = []
        trainer.step_fn = timed_steps(torch, trainer.step_fn, totals, steps)
        sg.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        metrics = {}
        for i, b in enumerate(batches[:n]):
            vec = trainer.train_step(trainer.to_device(host_slice(b, cfg.labeled_bs, rank, world)))
            metrics.update({f"{k}@{i + 1}": v for k, v in zip(trainer.metric_keys, vec.tolist())})
        out[kind] = {"steps": steps, "metrics": metrics, "digest": state_digest(torch, trainer),
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "sgd_bf16_launches": sg.sgd_bf16_update.launches}
        print(f"[dp-numbers] rank {rank} {kind}: steps {steps}; peak memory "
              f"{out[kind]['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        if kind == "f32" and rank == 0:
            test = (metrics, host_copy(float_state(trainer)))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    out["all_reduce"] = dict(totals)
    out["tp"], tp_test = tp_flagship_steps(torch, rank, world, totals, slices, cfg, batches)
    barrier(world_group())
    dist.destroy_process_group()
    if rank == 0:  # the one-process runs, alone on the card
        runs = {"test": test}
        variants = [{}, dict(scale=1.0 + 1e-7), dict(scale=1.0 - 1e-7), dict(reverse=True),
                    dict(global_batch_norm=True), dict(reverse=True, global_batch_norm=True)]
        for i, run in enumerate(one_process_runs(torch, cfg, batches, variants)):
            if i < 2:
                runs[("reference", "control")[i]] = run
            elif "witness" not in runs:
                runs["witness"] = run
            else:  # the witness keeps, per tensor, the farthest run from the reference
                ref, far = runs["reference"][1], runs["witness"][1]
                for k in ref:
                    if (run[1][k] - ref[k]).abs().max() > (far[k] - ref[k]).abs().max():
                        far[k] = run[1][k]
            del run
            gc.collect()
        first = {k: abs(v - runs["reference"][0][k]) / max(abs(runs["reference"][0][k]), 1e-12)
                 for k, v in test[0].items() if k.endswith("@1")}
        out["first_step_rel_err"] = max(first.values())
        print(f"[dp-numbers] the first step's loss terms, 2 ranks vs 1: largest relative error "
              f"{out['first_step_rel_err']:.3e} (tolerance {DP_METRIC_RTOL})", flush=True)
        if out["first_step_rel_err"] > DP_METRIC_RTOL:
            fail("[dp-numbers] the first step's loss terms disagree")
        step_agreement(torch, "[dp-numbers]", f"{DP_STEPS} f32 steps, 2 ranks vs 1 process (rule: "
                       "phase 18 over parameters, buffers and momentum; control = the one-process "
                       "run on the images times 1 + 1e-7, witness = per tensor the farthest of "
                       "the one-process runs on the images times 1 - 1e-7, on reversed rows, with "
                       "the data-parallel BatchNorm formula, with both)", before, runs)
        # 48: the tp=2 steps against the same one-process runs
        first = {k: abs(v - runs["reference"][0][k]) / max(abs(runs["reference"][0][k]), 1e-12)
                 for k, v in tp_test[0].items() if k.endswith("@1")}
        out["tp"]["first_step_rel_err"] = max(first.values())
        out["tp"]["one_process_first"] = {k[:-2]: v for k, v in runs["reference"][0].items()
                                          if k.endswith("@1")}
        print(f"[tp-flagship] the first step's loss terms, tp=2 vs 1 process: largest relative error "
              f"{out['tp']['first_step_rel_err']:.3e} (tolerance {DP_METRIC_RTOL})", flush=True)
        if out["tp"]["first_step_rel_err"] > DP_METRIC_RTOL:
            fail("[tp-flagship] the first step's loss terms disagree")
        step_agreement(torch, "[tp-flagship]", f"{DP_STEPS} f32 steps at full width, tp=2 vs 1 "
                       "process, gathered (the rule, control and witness of [dp-numbers])", before,
                       dict(runs, test=tp_test))
    return out


def dp_window_worker(torch, rank: int, world: int, port: int) -> dict:
    """Rank `rank` of phase 5's sliding window (SwinUNETR fs48, seeded
    weights, the seeded 160x160x128 volume) through
    make_fused_sliding_window(group=...) over a gloo group; its label map
    (DP_ROOT/window_rank{r}.npy), seconds and window-attention launches."""
    import numpy as np
    import torch.distributed as dist

    from icl_tpu_torch.eval.infer3d import make_fused_sliding_window
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.parallel.multihost import initialize_from_args

    initialize_from_args(f"127.0.0.1:{port}", world, rank, device=DEVICE)
    model = net_factory("swinunetr_icl", 1, 2, device=DEVICE, feature_size=FEATURE_SIZE,
                        generator=torch.Generator().manual_seed(0), inference=True).eval()
    volume = np.random.default_rng(0).standard_normal(VOLUME).astype(np.float32)
    predict = make_fused_sliding_window(model, 2, (PATCH,) * 3, SW_BATCH, device=DEVICE,
                                        group=dist.group.WORLD)
    predict(volume, STRIDE, STRIDE)  # warm-up
    wa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = predict(volume, STRIDE, STRIDE)
    seconds = time.perf_counter() - t0
    launches = dict(wa.window_attention.launches_by_mode)
    np.save(os.path.join(DP_ROOT, f"window_rank{rank}.npy"), labels)
    print(f"[dp-window] rank {rank}: {seconds:.3f} s/volume, launches {launches}", flush=True)
    return {"seconds": seconds, "launches": launches}


def dp_nccl1_worker(torch, rank: int, world: int, port: int) -> dict:
    """NCCL at world size 1 on the card: all_reduce_sum forward and backward,
    reduce_gradients (f32 and bf16 gradients, one bucket and one alone),
    all_gather_case_metrics and the barrier over the group, each result
    equal to its input."""
    import torch.distributed as dist

    from icl_tpu_torch.parallel import collectives
    from icl_tpu_torch.parallel.multihost import all_gather_case_metrics

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    group = dist.group.WORLD
    gen = torch.Generator(DEVICE).manual_seed(43)
    x = torch.randn(4096, device=DEVICE, generator=gen, requires_grad=True)
    g = torch.randn(4096, device=DEVICE, generator=gen)
    y = collectives.all_reduce_sum(x, group)
    y.backward(g)
    params = [torch.nn.Parameter(torch.randn(shape, device=DEVICE, generator=gen).to(dtype))
              for shape, dtype in (((7,), torch.float32), ((5, 3), torch.bfloat16),
                                   ((collectives.BUCKET_ELEMS + 3,), torch.float32))]
    for p in params:
        p.grad = torch.randn(p.shape, device=DEVICE, generator=gen).to(p.dtype)
    grads = [p.grad.clone() for p in params]
    collectives.reduce_gradients(params, group)
    local = [[(0.5, 1.0), (0.25, 2.0)], [(0.75, 3.0), (1.0, 4.0)]]
    gathered = all_gather_case_metrics(local, group)
    collectives.barrier(group)
    out = {"backend": dist.get_backend(group), "forward": torch.equal(y.detach(), x.detach()),
           "backward": torch.equal(x.grad, g),
           "reduce_gradients": all(torch.equal(p.grad, gr) for p, gr in zip(params, grads)),
           "case_metrics": gathered == local}
    dist.destroy_process_group()
    print(f"[dp-nccl1] {out}", flush=True)
    return out


DP_WORKERS = {"cli": dp_cli_worker, "numbers": dp_numbers_worker, "window": dp_window_worker,
              "nccl1": dp_nccl1_worker}  # and the tensor-parallel workers, below


def dp_worker(argv: list) -> int:
    """`--dp-worker kind rank world port out`: one rank of a phase-42/43
    run, its result as JSON in `out`."""
    kind, rank, world, port, out = argv
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = DP_WORKERS[kind](torch, int(rank), int(world), int(port))
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def phase_data_parallel(torch, slices, volumes) -> dict:
    """42: the flagship, 2 ranks on the one card. The CLI (`dp_cli_worker`):
    the ranks' final states bitwise equal (dropout on: both update from the
    same reduced gradients), only rank 0 wrote (the other rank's directory
    empty), test_2D_ACDC on its best checkpoint gives its validation dice,
    no window attention; the step's time split into compute and all-reduce
    and the peak memory per rank. The numbers (`dp_numbers_worker`): 2
    ranks against 1 process by phase 18's rule, the f32 and bf16 replicas
    bitwise equal, the SR kernel's launches in the bf16 steps."""
    from icl_tpu_torch.scripts import test_2D_ACDC

    t0 = time.perf_counter()
    ranks = spawn_ranks("cli", 2, 600)
    cli_s = time.perf_counter() - t0
    r0, r1 = ranks
    if r0["digest"] != r1["digest"]:
        fail("[dp-cli] the two ranks' final states differ")
    other = os.path.join(DP_ROOT, "rank1")
    written = [os.path.join(d, f) for d, _, files in os.walk(other) for f in files]
    if written or os.path.exists(os.path.join(other, "experiments")):
        fail(f"[dp-cli] rank 1 wrote {written[:5]}")
    if len(r0["vals"]) != 1 or r1["vals"] or r0["best_path"] is None or r1["best_path"] is not None:
        fail(f"[dp-cli] rank 0 must validate and save once, rank 1 never: {r0['vals']}, {r1['vals']}")
    if [row["loss"] for row in r0["log"]] != [row["loss"] for row in r1["log"]]:
        fail("[dp-cli] the ranks logged different losses")
    if any(n for r in ranks for counts in r["attention"].values() for n in counts.values()):
        fail(f"[dp-cli] the U-Net path launched window attention: {[r['attention'] for r in ranks]}")
    eval_dice = eval_cli(test_2D_ACDC, DP_CLI_ARGV, "ACDCDataset", InMemoryDataset(slices, volumes))
    val_dice = r0["vals"][0]["mean_dice"]
    print(f"[dp-cli] the flagship CLI as 2 ranks on the card (gloo), {DP_CLI_STEPS} step(s) and a "
          f"validation in {cli_s:.1f} s: final states bitwise equal (sha256 {r0['digest'][:16]}); "
          f"only rank 0 wrote; per step (the first with cuDNN's first calls) compute / all-reduce s "
          f"{[[(round(s['compute_s'], 4), round(s['all_reduce_s'], 4)) for s in r['steps']] for r in ranks]}; "
          f"all-reduce per rank {[r['all_reduce'] for r in ranks]}; peak memory per rank "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB; test_2D_ACDC on the best "
          f"checkpoint: mean dice {eval_dice!r}, the validation {val_dice!r}", flush=True)
    if eval_dice != val_dice:
        fail("[dp-cli] test_2D_ACDC does not reproduce the 2-rank run's validation dice")
    shutil.rmtree(DP_ROOT, ignore_errors=True)

    t0 = time.perf_counter()
    n0, n1 = spawn_ranks("numbers", 2, 900)
    for kind in ("f32", "bf16"):
        if n0[kind]["digest"] != n1[kind]["digest"]:
            fail(f"[dp-numbers] the {kind} replicas differ")
    launches = [n[k]["sgd_bf16_launches"] for n in (n0, n1) for k in ("f32", "bf16")]
    print(f"[dp-numbers] 2 ranks vs 1 process in {time.perf_counter() - t0:.1f} s: f32 and bf16 "
          f"replicas bitwise equal; SR kernel launches per rank (f32, bf16 runs) {launches}; "
          f"per step compute / all-reduce s "
          f"{[[(round(s['compute_s'], 4), round(s['all_reduce_s'], 4)) for s in n[k]['steps']] for n in (n0, n1) for k in ('f32', 'bf16')]}; "
          f"peak memory per rank {[round(n['f32']['peak_bytes'] / 2**30, 2) for n in (n0, n1)]} GiB",
          flush=True)
    if launches[0] or launches[2] or launches[1] != launches[3] or not launches[1]:
        fail(f"[dp-numbers] the SR kernel's launches per rank {launches}")
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    return {"cli": {"steps": [r["steps"] for r in ranks], "all_reduce": [r["all_reduce"] for r in ranks],
                    "peak_bytes": [r["peak_bytes"] for r in ranks], "val_dice": val_dice,
                    "seconds": cli_s},
            "numbers": {"steps": {k: [n[k]["steps"] for n in (n0, n1)] for k in ("f32", "bf16")},
                        "first_step_rel_err": n0["first_step_rel_err"],
                        "peak_bytes": [n["f32"]["peak_bytes"] for n in (n0, n1)]},
            "sgd_bf16_launches": launches[1] + launches[3], "tp": [n0["tp"], n1["tp"]]}


def stitched_margin(torch, model, volume) -> "np.ndarray":
    """|p1 - p0| of the one-process mean-stitched softmax of phase 5's
    sliding window (2 classes), [W, H, D] on the host."""
    from icl_tpu_torch.eval.infer3d import _grid_starts, make_patch_predictor

    probs_fn = make_patch_predictor(model)
    score = torch.zeros((2,) + VOLUME, device=DEVICE)
    cnt = torch.zeros(VOLUME, device=DEVICE)
    vol = torch.from_numpy(volume).to(DEVICE)
    starts = [(x, y, z) for x in _grid_starts(VOLUME[0], PATCH, STRIDE)
              for y in _grid_starts(VOLUME[1], PATCH, STRIDE) for z in _grid_starts(VOLUME[2], PATCH, STRIDE)]
    for x, y, z in starts:
        p = probs_fn(vol[x:x + PATCH, y:y + PATCH, z:z + PATCH][None, None])[0]
        score[:, x:x + PATCH, y:y + PATCH, z:z + PATCH] += p
        cnt[x:x + PATCH, y:y + PATCH, z:z + PATCH] += 1
    mean = score / cnt
    return (mean[1] - mean[0]).abs().cpu().numpy()


def phase_collectives_and_window(torch) -> dict:
    """43: NCCL at world size 1 on the card (`dp_nccl1_worker`); phase 5's
    sliding window through make_fused_sliding_window(group=...) over 2 gloo
    ranks on the card, whose label map must equal the one-process map but
    at voxels whose top-two scores tie within 1e-6 (counted), and whose
    window-attention launches are counted per rank."""
    import numpy as np

    from icl_tpu_torch.eval.infer3d import _grid_starts, make_fused_sliding_window
    from icl_tpu_torch.models.registry import net_factory

    nccl_run = start_ranks("nccl1", 1)  # beside the window's ranks
    ranks = spawn_ranks("window", 2, 300)
    (nccl,) = finish_ranks(nccl_run, 300)
    if nccl["backend"] != "nccl" or not all(nccl[k] for k in ("forward", "backward", "reduce_gradients",
                                                                "case_metrics")):
        fail(f"[dp-nccl1] a collective at world size 1 changed its input: {nccl}")
    maps = [np.load(os.path.join(DP_ROOT, f"window_rank{r}.npy")) for r in range(2)]
    model = net_factory("swinunetr_icl", 1, 2, device=DEVICE, feature_size=FEATURE_SIZE,
                        generator=torch.Generator().manual_seed(0), inference=True).eval()
    volume = np.random.default_rng(0).standard_normal(VOLUME).astype(np.float32)
    want = make_fused_sliding_window(model, 2, (PATCH,) * 3, SW_BATCH, device=DEVICE)(volume, STRIDE, STRIDE)
    if not np.array_equal(maps[0], maps[1]):
        fail("[dp-window] the two ranks' label maps differ")
    differ = maps[0] != want
    ties = 0
    if differ.any():
        margin = stitched_margin(torch, model, volume)
        ties = int((differ & (margin <= 1e-6)).sum())
        if ties != int(differ.sum()):
            fail(f"[dp-window] {int(differ.sum())} voxels differ from the one-process map, "
                 f"{ties} of them near-ties")
    launches = {m: sum(r["launches"][m] for r in ranks) for m in ("none", "region", "mask")}
    per_forward = {m: sum(PER_FORWARD[m].values()) for m in ("none", "region")}
    n_chunks = math.ceil(math.prod(len(_grid_starts(d, PATCH, STRIDE)) for d in VOLUME) / SW_BATCH)
    print(f"[dp-window] phase 5's sliding window over 2 gloo ranks on the card: label maps equal "
          f"on both ranks; {int(differ.sum())} voxels differ from the one-process map ({ties} "
          f"near-ties within 1e-6); s/volume per rank {[round(r['seconds'], 3) for r in ranks]}; "
          f"window-attention launches per rank {[r['launches'] for r in ranks]} ({n_chunks} "
          f"forwards in all, {per_forward} per forward)", flush=True)
    for m in ("none", "region"):
        if launches[m] != n_chunks * per_forward[m]:
            fail(f"[dp-window] {m} launches {launches[m]}, want {n_chunks * per_forward[m]}")
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    return {"nccl1": nccl, "launches": launches, "launches_per_rank": [r["launches"] for r in ranks],
            "differ": int(differ.sum()), "ties": ties, "seconds": [r["seconds"] for r in ranks]}


# Phases 44-46: gradient accumulation on the flagship (U-Net-ICL 2D at 256^2,
# batch 16 of which 8 labeled, f32: the JAX trainer's `grad_accum`, wrapped
# in optax.MultiSteps there); FixMatch-CTA with the Swin-UNet through its CLI
# (the JAX CLI's `--model swinunet --patch_size 224 224`: embed 96, window 7,
# batch 16 of which 8 labeled, f32); the analytic FLOP lines of every
# `Trainer.fit` of the run.
ACCUM_K = 2
CTA_SWIN_EXP, CTA_SWIN_STEPS = "ACDC_chip_smoke/FixMatch_CTA_Swin", 3
CTA_SWIN_CPU_EMBED = 48  # the card-vs-CPU step at head dim 16, within the CPU's time
# the window-attention launches of one FixMatch-CTA Swin-UNet step: the weak
# forward (batch 16), the strong one (batch 8) and the probe's (batch 1), the
# first two also backward
CTA_SWIN_PER_STEP = {"fwd": {m: 3 * n for m, n in SWIN_SUP_PER_STEP.items()},
                     "bwd": {m: 2 * n for m, n in SWIN_SUP_PER_STEP.items()}}
FIT_RUNS: list = []  # one record per Trainer.fit of the run (`record_fits`)


def record_fits() -> None:
    """Wrap `Trainer.fit` so that every run of it records its model,
    precision, analytic FLOPs per step, iterations and seconds, and whether
    its log.txt holds the JAX trainer's two FLOP lines."""
    from icl_tpu_torch.train.trainer import Trainer

    real = Trainer.fit

    def fit(self, *args, **kwargs):
        result = real(self, *args, **kwargs)
        with open(os.path.join(self.cfg.snapshot_path, "log.txt")) as f:
            text = f.read()
        FIT_RUNS.append({"model": self.cfg.model, "exp": self.cfg.exp, "precision": self.cfg.precision,
                         "state_dtype": self.cfg.state_dtype, "grad_accum": self.cfg.grad_accum,
                         "scan_steps": self.cfg.scan_steps, "step_flops": result["step_flops"],
                         "iterations": self.iteration, "seconds": result["seconds"],
                         "log_lines": ("analytic step cost:" in text,
                                       "end-to-end analytic" in text)})
        return result

    Trainer.fit = fit


def device_state(torch, trainer) -> dict:
    """A copy on the card of everything of `trainer` that a step changes
    (`train_state` with its tensors cloned)."""
    def clone(x):
        if torch.is_tensor(x):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x

    return clone(trainer.train_state())


def drop_graphs(trainer) -> None:
    """Forget `trainer`'s captured graphs, their static inputs and memory
    pool, so that its next `graph_step` of each kind captures anew."""
    trainer._graphs, trainer._graph_inputs, trainer._graph_pool = {}, None, None


def step_tensors(trainer) -> dict:
    """The live tensors a step changes: parameters, buffers, momentum and
    accumulators."""
    out = {f"param/{n}": p.detach() for n, p in trainer.model.named_parameters()}
    out.update({f"buffer/{n}": b for n, b in trainer.model.named_buffers()})
    out.update({f"momentum/{i}": b for i, b in enumerate(trainer.optimizer.momentum_buffers)})
    out.update({f"accumulator/{i}": b for i, b in enumerate(trainer.optimizer.accumulators)})
    return out


def phase_grad_accum(torch, wa, slices, volumes) -> dict:
    """44: gradient accumulation (k = ACCUM_K) on the flagship at full
    width, `zero_stochastic` and cuDNN's deterministic algorithms for the
    bitwise checks: 2k micro-steps on one repeated batch against 2 k = 1
    updates, the first of them counted for FLOPs (parameters and momentum
    bit for bit; the parameters untouched inside a window); 4 replays of
    the two captured graphs (accumulate, accumulate and update) against 4
    eager micro-steps from one state on 4 batches (every tensor a step
    changes and the metrics bit for bit); then, with cuDNN's deterministic
    algorithms off as users run, s/step of k = 2 and k = 1 (the two
    trainers of the bitwise check, both captured anew), eager and replayed,
    in turns; then
    `fit` of the k = 2 trainer for 4 steps in
    a group of 4 replays with a validation at 4: its loss lines, its
    logged LRs (each that of its update), its FLOP lines and peak
    memory."""
    import dataclasses
    import gc
    import itertools

    from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator

    t_phase = time.perf_counter()
    base = unet_config(100, 0, "accum", zero_stochastic=True)
    cfg_k = dataclasses.replace(base, grad_accum=ACCUM_K, scan_steps=GRAPH_STEPS)
    cfg_1 = dataclasses.replace(base, num_tries="accum1", scan_steps=GRAPH_STEPS)
    t0 = time.perf_counter()
    acc, ref = Trainer(cfg_k, device=DEVICE), Trainer(cfg_1, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batches = [acc.to_device(b) for b in itertools.islice(acdc_batches(slices, cfg_k), GRAPH_STEPS)]
    pa, pr = step_tensors(acc), step_tensors(ref)
    params = [k for k in pr if k.startswith("param/")]
    moms = [k for k in pr if k.startswith("momentum/")]

    def same(keys, a=pa, b=pr) -> list:
        return [k for k in keys if not torch.equal(a[k], b[k])]

    torch.backends.cudnn.deterministic = True
    try:
        if same(params):
            fail("[accum] the two trainers did not start from the same weights")
        frozen, differ = [], []
        for update in range(2):
            for _ in range(ACCUM_K - 1):
                acc._stacked_step(batches[0])
                frozen.append(len(same(params)))  # ref has not taken this update yet
            acc._stacked_step(batches[0])
            if update == 0:
                ref.count_step_flops(batches[0])  # the counted step
            else:
                ref._stacked_step(batches[0])
            differ.append((len(same(params)), len(same(moms))))
        torch.cuda.synchronize()
        print(f"[accum] flagship U-Net-ICL 2D at full width, f32, k = {ACCUM_K}: {2 * ACCUM_K} "
              f"micro-steps on one batch against 2 k = 1 updates (the first counted for FLOPs, "
              f"{ref.step_flops / 1e9:.1f} GFLOP): (parameters, momentum buffers) that differ after "
              f"each update {differ} of ({len(params)}, {len(moms)}); parameters moved inside a "
              f"window {frozen}; built both in {build_s:.2f} s", flush=True)
        if any(frozen) or any(n for pair in differ for n in pair):
            fail("[accum] the accumulated updates are not the k = 1 updates, or a window moved")
        del pa, pr

        s0 = device_state(torch, acc)
        for b in batches[:ACCUM_K]:  # the captures, one graph a kind
            acc.graph_step(b)
        acc.load_train_state(s0)
        eager = [acc._stacked_step(b) for b in batches]
        a = {k: t.clone() for k, t in step_tensors(acc).items()}
        acc.load_train_state(s0)
        replays = acc.replays
        replayed = [acc.graph_step(b) for b in batches]
        torch.cuda.synchronize()
        b_state = step_tensors(acc)
        replay_differ = sorted(k for k in a if not torch.equal(a[k], b_state[k]))
        metrics_equal = torch.equal(torch.stack(eager), torch.stack(replayed))
        print(f"[accum] {GRAPH_STEPS} replays of the two captured graphs against {GRAPH_STEPS} eager "
              f"micro-steps from one state on {GRAPH_STEPS} batches (cuDNN deterministic): "
              f"{len(replay_differ)} of {len(a)} tensors differ {replay_differ[:8]}, metrics equal "
              f"{metrics_equal}; replays counted {acc.replays - replays}; launches recorded in the "
              f"update graph {acc.graph_launches}", flush=True)
        if replay_differ or not metrics_equal or acc.replays - replays != GRAPH_STEPS:
            fail("[accum] the replayed micro-steps differ from the eager ones")
        del a, b_state, eager, replayed, s0
    finally:
        torch.backends.cudnn.deterministic = False

    # s/step as users run it (cuDNN's own algorithm choice): both trainers
    # captured anew, then k = 2 and k = 1, eager and replayed, in turns
    drop_graphs(acc)
    gc.collect()
    torch.cuda.empty_cache()
    times = {"k1_eager": [], "k2_eager": [], "k1_replayed": [], "k2_replayed": []}
    for trainer in (acc, ref):
        for b in batches[:ACCUM_K]:
            trainer.graph_step(b)

    def run(trainer, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(batches)

    for kind in ("eager", "replayed", "replayed", "eager"):
        for name, trainer in (("k2", acc), ("k1", ref)):
            step = trainer._stacked_step if kind == "eager" else trainer.graph_step
            times[f"{name}_{kind}"].append(run(trainer, step))
    print(f"[accum] s/step with cuDNN's algorithms free, {len(batches)} steps a turn: "
          f"{json.dumps(times)}", flush=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    if acc.optimizer.micro:
        fail("[accum] the timed runs left a window open")
    acc.optimizer.count = 0  # the fit starts a run (update 0, iteration 0) from these weights
    acc.cfg = dataclasses.replace(cfg_k, max_iterations=GRAPH_STEPS, val_interval=GRAPH_STEPS,
                                  num_tries="accum_fit")
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    validate = acdc_evaluator(volumes, CLASSES_2D, cfg_k.patch_size, acc.device)
    result = acc.fit(iter(batches), evaluate=validate)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    path = launches_now(wa)
    drop_states(result)
    log = result["log"]
    print_log("[accum-fit]", log, acc.metric_keys)
    lrs = [r["lr"] for r in log]
    want_lrs = [acc.optimizer.schedule((r["iteration"] - 1) // ACCUM_K) for r in log]
    s_per_step = log[-1]["seconds"] / len(log)  # one group: its steps are logged together
    with open(os.path.join(acc.cfg.snapshot_path, "log.txt")) as f:
        flop_lines = [ln.split(" - ")[-1] for ln in f.read().splitlines()
                      if "analytic step cost" in ln or "end-to-end analytic" in ln]
    print(f"[accum-fit] fit, k = {ACCUM_K}, {len(log)} steps in a group of {GRAPH_STEPS} replays and "
          f"a validation: {s_per_step:.4f} s/step (the group's replays and their logging); "
          f"validation mean dice {result['vals'][-1]['mean_dice'] if result['vals'] else None!r}; "
          f"logged LRs {lrs} (each its update's: {want_lrs}); updates {acc.optimizer.count}; peak "
          f"memory {peak / 2**30:.2f} GiB; window-attention launches {path}; log.txt: {flop_lines}",
          flush=True)
    if len(log) != GRAPH_STEPS or not result["vals"] or lrs != want_lrs or len(flop_lines) != 2 \
            or acc.optimizer.count != GRAPH_STEPS // ACCUM_K:
        fail("[accum-fit] the accumulating fit did not log its steps, LRs, validation and FLOP lines")
    no_attention("[accum-fit]", path)
    out = {"times": times, "peak_bytes": peak, "fit_s_per_step": s_per_step, "build_s": build_s,
           "step_flops": acc.step_flops, "path_launches": path,
           "seconds": time.perf_counter() - t_phase}
    del acc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def clear_threshold(torch, confs) -> tuple[float, float]:
    """The middle of the widest gap between sorted confidences from their
    30th to their 70th percentile, and half that gap."""
    confs = confs.flatten().sort().values
    lo, hi = int(0.3 * len(confs)), int(0.7 * len(confs))
    gaps = confs[lo + 1:hi] - confs[lo:hi - 1]
    widest = int(gaps.argmax())
    return float((confs[lo + widest] + confs[lo + widest + 1]) / 2), float(gaps[widest]) / 2


def kernel_events(path: str) -> list:
    """The card's kernel events of a Chrome trace (name, grid, microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], str(e.get("args", {}).get("grid")), float(e.get("dur", 0.0))) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def phase_fixmatch_cta_swin(torch, wa, slices, volumes) -> dict:
    """45: FixMatch-CTA with the Swin-UNet through its CLI's `main` (the JAX
    CLI's `--model swinunet --patch_size 224 224`: embed 96, window 7,
    batch 16 of which 8 labeled, f32) for CTA_SWIN_STEPS steps, the
    window-attention launches of the run asserted (per step: the weak,
    strong and probe forwards, 8 no-mask + 6 mask each, the first two
    backward), then a validation of its final weights on the volumes; one
    step through the kernels against the same step with the plain
    attention, beside a control, by phase 15's rule; one f32 step on the
    card against the CPU's f64 step (embed 48, head dim 16), the CPU's f32
    step the witness, phase 34's rule; one step traced (`utils.profiling.
    trace`): the kernels it names, the device's ms, the window-attention
    launches' ms per call; the step's analytic FLOPs."""
    import gc

    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.data.pipeline import cta_batches
    from icl_tpu_torch.models.layers import DropPath
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.models.swin2d import SwinConfig, WindowAttention
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_fixmatch_cta_step
    from icl_tpu_torch.train.trainer import acdc_evaluator
    from icl_tpu_torch.utils import checkpoint as ckpt
    from icl_tpu_torch.utils import flops
    from icl_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    side = IMG_SWIN_SUP
    data = InMemoryDataset(slices, volumes)
    snapshot = cta_snapshot(CTA_SWIN_EXP, "swinunet")
    shutil.rmtree(os.path.dirname(snapshot), ignore_errors=True)
    want = {k: {m: CTA_SWIN_STEPS * v.get(m, 0) for m in ("none", "region", "mask")}
            for k, v in CTA_SWIN_PER_STEP.items()}
    torch.manual_seed(0)  # drop-path masks
    run = cta_cli(torch, wa, ["--model", "swinunet", "--patch_size", str(side), str(side), "--exp",
                              CTA_SWIN_EXP, "--max_iterations", str(CTA_SWIN_STEPS)], data,
                  "[cta-swin]", launches=want)
    model = net_factory("swinunet", 1, CLASSES_2D, device=DEVICE, patch_size=side)
    model.load_state_dict(ckpt.load_train_state(snapshot, "last", DEVICE)["model"], strict=True)
    drop_states(run)
    wa.reset_launch_counts()
    t0 = time.perf_counter()
    agg = acdc_evaluator(volumes, CLASSES_2D, (side, side), DEVICE)(model.eval())
    val_s = time.perf_counter() - t0
    val_launches = launches_now(wa)
    chunks = sum(math.ceil(v["image"].shape[0] / 32) for v in volumes)
    print(f"[cta-swin] a validation of the final weights on {len(volumes)} volumes in {val_s:.3f} s: "
          f"mean dice {agg['mean_dice']!r} hd95 {agg['mean_hd95']!r}; launches {val_launches} "
          f"({chunks} chunks)", flush=True)
    if not math.isfinite(agg["mean_dice"]) or val_launches["fwd"] != {
            "none": chunks * SWIN_SUP_PER_STEP["none"], "region": 0, "mask": chunks * SWIN_SUP_PER_STEP["mask"]}:
        fail("[cta-swin] the validation's dice or launches are wrong")
    del model
    gc.collect()

    batch = next(cta_batches(slices, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, (side, side),
                             CTAugment(seed=1337), seed=1337))

    def build(device, dtype, plain=False, embed=96):
        model = net_factory("swinunet", 1, CLASSES_2D, device=device, generator=torch.Generator().manual_seed(45),
                            swin_cfg=SwinConfig(img_size=side, window_size=WINDOW_SWIN_SUP, embed_dim=embed))
        for m in model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
            if plain and isinstance(m, WindowAttention):
                m.attention = wa.window_attention_plain
        return model.to(dtype)

    def threshold(model) -> tuple[float, float]:
        with torch.no_grad():
            logits = model(torch.as_tensor(batch["image_weak"]).to(next(model.parameters())))
        return clear_threshold(torch, torch.softmax(logits[LABELED_2D:].double(), 1).amax(1))

    # the kernels against the plain attention, f32 on the card
    conf, margin = threshold(build(DEVICE, torch.float32, plain=True))
    starts, runs = {}, {}
    for name, plain, scale in (("test", False, 1.0), ("reference", True, 1.0), ("control", False, 1.0 + 1e-7)):
        model = build(DEVICE, torch.float32, plain)
        starts[name] = {n: p.detach().clone() for n, p in model.named_parameters()}
        wa.reset_launch_counts()
        metrics, after, _ = fixmatch_step(torch, model, batch, DEVICE, conf, scale)
        runs[name] = (metrics, {n: t.clone() for n, t in after.items()}, launches_now(wa))
        del model
    launched = {k: r[2] for k, r in runs.items()}
    print(f"[cta-swin-step] threshold {conf:.7f} ({margin:.2e} from the nearest confidence); mask "
          f"ratios {({k: r[0]['mask_ratio'] for k, r in runs.items()})}; launches {launched}", flush=True)
    # the step's launches and those of `fixmatch_step`'s separate probe forward
    with_probe = {"fwd": {m: n + SWIN_SUP_PER_STEP[m] for m, n in CTA_SWIN_PER_STEP["fwd"].items()},
                  "bwd": CTA_SWIN_PER_STEP["bwd"]}
    if launched["reference"]["fwd"] != {"none": 0, "region": 0, "mask": 0} \
            or {k: {m: v.get(m, 0) for m in SWIN_SUP_PER_STEP} for k, v in launched["test"].items()} \
            != with_probe:
        fail(f"[cta-swin-step] launches {launched}, expected {with_probe} with the kernels")
    step_agreement(torch, "[cta-swin-step]", f"one {side}^2 f32 FixMatch-CTA Swin-UNet step, kernels vs "
                   "plain attention", starts["test"], {k: runs[k][:2] for k in runs})
    del runs, starts
    gc.collect()
    torch.cuda.empty_cache()

    # the card's f32 step against the CPU's f64 step, the CPU's f32 step the witness
    cpu_model = build("cpu", torch.float64, embed=CTA_SWIN_CPU_EMBED)
    conf, margin = threshold(cpu_model)
    del cpu_model
    starts, runs = {}, {}
    t0 = time.perf_counter()
    for name, device, dtype in (("test", DEVICE, torch.float32), ("reference", "cpu", torch.float64),
                                ("witness", "cpu", torch.float32)):
        model = build(device, dtype, embed=CTA_SWIN_CPU_EMBED)
        starts[name] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        metrics, after, _ = fixmatch_step(torch, model, batch, device, conf)
        runs[name] = (metrics, {n: t.cpu().clone() for n, t in after.items()})
        del model
    pixels = (BATCH_2D - LABELED_2D) * side * side
    kept = {k: round(r[0]["mask_ratio"] * pixels) for k, r in runs.items()}  # the ratio's f32 rounding aside
    print(f"[cta-swin-cpu] embed {CTA_SWIN_CPU_EMBED} at {side}^2, threshold {conf:.7f} ({margin:.2e} "
          f"from the nearest confidence): pixels kept {kept} of {pixels}; the three steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(set(kept.values())) != 1:
        fail("[cta-swin-cpu] the steps' masks part")
    step_agreement(torch, "[cta-swin-cpu]", f"one {side}^2 f32 FixMatch-CTA Swin-UNet step on the card vs "
                   "the CPU's f64 step (witness: the CPU's f32 step)", starts["test"],
                   {"test": runs["test"], "reference": runs["reference"], "witness": runs["witness"]})
    del runs, starts
    gc.collect()

    # one step at the CLI's width traced, one counted for FLOPs, three timed
    model = build(DEVICE, torch.float32)
    opt = PolySGD(model.parameters(), 0.01, 30000)
    step = make_fixmatch_cta_step(model, opt, CLASSES_2D, LABELED_2D, 0.95, 1.0)
    on_device = {k: torch.as_tensor(batch[k]).to(DEVICE, torch.float32)
                 for k in ("image_weak", "image_strong", "probe_image")}
    on_device.update({k: torch.as_tensor(batch[k]).to(DEVICE).long() for k in ("label_aug", "probe_label")})
    step(on_device)  # warm-up: plans, allocator
    torch.cuda.synchronize()
    logdir = os.path.join(ROOT, "build", "chip_smoke", "trace")
    with trace(logdir) as prof:
        step(on_device)
        torch.cuda.synchronize()
    events = kernel_events(prof.trace_path)
    attn, by_grid = {}, {}
    for name, grid, dur in events:
        for kernel in ("window_attention_bwd_kernel", "window_attention_kernel", "dbias_reduce_kernel"):
            if kernel in name:
                attn.setdefault(kernel, []).append(dur / 1e3)
                by_grid.setdefault(f"{kernel} grid {grid}", []).append(dur / 1e3)
                break
    device_ms = sum(d for _, _, d in events) / 1e3
    with flops.counting() as count:
        step(on_device)
    torch.cuda.synchronize()
    step_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(on_device)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    summary = {k: {"launches": len(v), "ms": sum(v), "ms_per_call": sum(v) / len(v)} for k, v in attn.items()}
    per_grid = {k: {"launches": len(v), "ms_per_call": sum(v) / len(v)} for k, v in sorted(by_grid.items())}
    print(f"[cta-swin-trace] {prof.trace_path}: {len(events)} kernels, {device_ms:.3f} ms of device "
          f"time in the step; the window-attention kernels it names {json.dumps(summary)}; the step's "
          f"analytic FLOPs {count.total / 1e9:.1f} GFLOP ({count.kernel_flops / 1e9:.1f} of them the "
          f"attention kernels'); the step alone {[round(t, 4) for t in step_s]} s; the kernels by "
          f"grid (CTA groups, heads) {json.dumps(per_grid)}", flush=True)
    fwd_calls = sum(CTA_SWIN_PER_STEP["fwd"].values())
    bwd_calls = sum(CTA_SWIN_PER_STEP["bwd"].values())
    if len(attn.get("window_attention_kernel", [])) != fwd_calls \
            or len(attn.get("window_attention_bwd_kernel", [])) != bwd_calls:
        fail(f"[cta-swin-trace] the trace names {summary}, expected {fwd_calls} forward and "
             f"{bwd_calls} backward window-attention kernels")
    del model, opt, step, on_device
    gc.collect()
    torch.cuda.empty_cache()
    return {"cli": {k: run[k] for k in ("s_per_step", "peak_bytes", "path_launches", "run_s")},
            "val_s": val_s, "val_dice": agg["mean_dice"], "val_launches": val_launches,
            "device_ms": device_ms, "kernels": summary, "by_grid": per_grid, "step_s": step_s,
            "step_flops": count.total,
            "seconds": time.perf_counter() - t_phase}


def phase_flop_lines(torch) -> dict:
    """46: the analytic FLOP lines of every `Trainer.fit` of the run: each
    run's GFLOP/step (its first step counted) and end-to-end TFLOP/s
    (validations and saves included), and both lines in its log.txt
    (asserted)."""
    rows = []
    for r in FIT_RUNS:
        rate = r["step_flops"] * r["iterations"] / r["seconds"] / 1e12 if r["step_flops"] else None
        rows.append({**r, "gflop_per_step": r["step_flops"] and r["step_flops"] / 1e9, "tflops": rate})
        print(f"[flops] {r['model']} ({r['exp']}, {r['precision']}, state {r['state_dtype']}, "
              f"grad_accum {r['grad_accum']}, scan_steps {r['scan_steps']}): "
              f"{(r['step_flops'] or 0) / 1e9:.1f} GFLOP/step, {r['iterations']} iterations in "
              f"{r['seconds']:.2f} s, end-to-end {rate if rate is None else round(rate, 3)} TFLOP/s; "
              f"log.txt lines {r['log_lines']}", flush=True)
    missing = [r["exp"] for r in rows if not r["step_flops"] or r["log_lines"] != (True, True)]
    if not rows or missing:
        fail(f"[flops] fits without their FLOP count or lines: {missing}")
    return {"runs": rows}


# Phases 47-52: tensor parallelism over a model axis (`parallel/mesh.py`,
# `parallel/tensor.py`): the flagship U-Net-ICL 2D at the JAX CLI's defaults
# and SwinUNETR-ICL fs48 at 96^3 (phase 9's configuration) over tp=2, the
# flagship over dp2 x tp2; every rank a `--dp-worker` process of this script
# on the one card, joined by gloo (NCCL takes one rank per card).
TP_ROOT = os.path.join(ROOT, "build", "chip_smoke_tp")  # outlives phase 43's clean-up
TP_SWIN_STEPS, TP_DP_STEPS, TP_SMALL_SIDE = 2, 1, 128
# the tp=2 validation against one process and the two ranks' against each
# other: f32 sums in another order, and the sliding window's stitch adds
# overlapping patches with atomics on the card (a near-tie may flip a voxel)
TP_DICE_ATOL = 1e-4


def tp_job() -> dict:
    with open(os.path.join(TP_ROOT, "job.json")) as f:
        return json.load(f)


def local_heads_of(heads: int, model: int = 2) -> int:
    """The heads a rank launches with: its share, or all of them where the
    count does not divide (the layer stays replicated)."""
    return heads // model if heads % model == 0 else heads


def train_state_digest(torch, state: dict) -> str:
    """sha256 over a train state's (`Trainer.train_state` layout) model
    tensors and momentum buffers, names and bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    items = list(state["model"].items())
    items += [(f"momentum/{i}", s["momentum_buffer"]) for i, s in state["optimizer"]["state"].items()]
    for name, t in items:
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def gathered_state(trainer) -> dict:
    """The trainer's state in the one-process layout (every rank of the
    model group calls)."""
    from icl_tpu_torch.utils.checkpoint import gather_train_state

    return gather_train_state(trainer.train_state(), trainer.model, trainer.optimizer)


def gathered_float_state(trainer) -> dict:
    """`float_state` in the one-process layout, on the host (every rank of
    the model group calls)."""
    from icl_tpu_torch.utils.checkpoint import host_copy

    state = gathered_state(trainer)
    model = state["model"]
    out = {f"param/{n}": model[n] for n, _ in trainer.model.named_parameters()}
    out.update({f"buffer/{n}": model[n] for n, b in trainer.model.named_buffers()
                if b.is_floating_point() and n in model})
    out.update({f"momentum/{i}": s["momentum_buffer"] for i, s in state["optimizer"]["state"].items()})
    return host_copy(out)


def replicated_digest(torch, trainer) -> str:
    """sha256 of this rank's replicated leaves: the state_dict entries and
    momentum buffers of the parameters that no rule splits."""
    from icl_tpu_torch.parallel.tensor import param_splits

    splits = param_splits(trainer.model)
    names = [n for n, _ in trainer.model.named_parameters()]
    state = {"model": {k: v for k, v in trainer.model.state_dict().items() if k not in splits},
             "optimizer": {"state": {i: {"momentum_buffer": b}
                                     for i, b in enumerate(trainer.optimizer.momentum_buffers)
                                     if names[i] not in splits}}}
    return train_state_digest(torch, state)


def restore_local(trainer, state: dict) -> None:
    """Put back a deep copy of this rank's own `train_state()`."""
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.optimizer.count = state["count"]
    trainer.iteration = state["iteration"]


def per_step_collectives(totals: dict, before: dict, steps: int) -> dict:
    return {"calls": (totals["calls"] - before["calls"]) / steps,
            "bytes": (totals["bytes"] - before["bytes"]) / steps,
            "seconds": (totals["seconds"] - before["seconds"]) / steps}


def tp_flagship_steps(torch, rank: int, world: int, totals: dict, slices, cfg, batches) -> tuple:
    """48, 51, 52 on rank `rank` of `dp_numbers_worker`'s group, after its
    data-parallel runs: the flagship over tp=2 (1 x 2), `Trainer` at full
    width on `cfg` (phase 42's: 256^2, batch 16 of which 8 labeled, f32,
    zero_stochastic, cuDNN deterministic) for its steps on `batches`, twice
    from one state (the eager repeat), timed with the collectives of each
    step, the digests of its replicated leaves and of its shards; at
    TP_SMALL_SIDE a bf16-state `fit` of 2 steps with its SR launches, the
    restore of the one-process save that the main process wrote, gathered,
    and a save after one more step. Returns (the numbers, the gathered
    float state after the steps on rank 0, else None): phase 42's
    one-process runs hold it by phase 18's rule."""
    import copy
    import dataclasses
    import gc

    from icl_tpu_torch.ops import sgd_bf16 as sg, window_attention as wa
    from icl_tpu_torch.parallel.mesh import create_mesh
    from icl_tpu_torch.train.optim import shard_runs
    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils import checkpoint as ckpt

    job = tp_job()
    mesh = create_mesh(data=1, model=world, device=DEVICE)
    tp_cfg = dataclasses.replace(cfg, num_tries="tp", log_flops=False)
    t0 = time.perf_counter()
    trainer = Trainer(tp_cfg, device=DEVICE, mesh=mesh)
    build_s = time.perf_counter() - t0
    local_params = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    start = copy.deepcopy(trainer.train_state())
    step_fn = trainer.step_fn
    out = {"build_s": build_s, "param_bytes": local_params, "runs": []}
    wa.reset_launch_counts()
    for _ in range(2):
        restore_local(trainer, start)
        steps = []
        trainer.step_fn = timed_steps(torch, step_fn, totals, steps)
        mark = dict(totals)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics = {}
        for i, b in enumerate(batches):
            vec = trainer.train_step(trainer.to_device(b))
            metrics.update({f"{k}@{i + 1}": v for k, v in zip(trainer.metric_keys, vec.tolist())})
        torch.cuda.synchronize()
        out["runs"].append({"steps": steps, "metrics": metrics, "digest": state_digest(torch, trainer),
                            "replicated": replicated_digest(torch, trainer),
                            "peak_bytes": torch.cuda.max_memory_allocated(),
                            "collectives": per_step_collectives(totals, mark, len(batches))})
    out["attention"] = launches_now(wa)
    test = (out["runs"][0]["metrics"], gathered_float_state(trainer))
    if rank:
        test = None
    print(f"[tp-flagship] rank {rank}: built and sharded in {build_s:.1f} s, {local_params / 1e9:.3f} "
          f"GB of parameters; runs {[{k: r[k] for k in ('steps', 'peak_bytes', 'collectives')} for r in out['runs']]}",
          flush=True)
    trainer.step_fn = step_fn
    del trainer, start
    gc.collect()
    torch.cuda.empty_cache()

    # at TP_SMALL_SIDE: the bf16 state, a 2-step fit, the SR kernel launched on
    # every run of every shard (phase 51 holds the full-width leaves); then the
    # one-process save restored at tp=2, and a tp=2 save
    small = unet_config(30000, 0, "tp_small", side=TP_SMALL_SIDE, zero_stochastic=True)
    sb = [b for _, b in zip(range(2), acdc_batches(slices, small))]
    cfg16 = dataclasses.replace(small, state_dtype="bfloat16", max_iterations=2, num_tries="tp_bf16",
                                log_flops=False)
    trainer = Trainer(cfg16, device=DEVICE, mesh=mesh)
    runs_per_update = sum(len(shard_runs(sh, (p,))) for p, sh in zip(trainer.optimizer.params,
                                                                  trainer.optimizer.shards))
    sg.reset_launch_counts()
    result = trainer.fit(iter(sb))
    drop_states(result)
    out["bf16"] = {"launches": sg.sgd_bf16_update.launches, "expected": 2 * runs_per_update,
                   "losses": [row["loss"] for row in result["log"]],
                   "leaves": len(trainer.optimizer.params)}
    print(f"[tp-flagship] rank {rank}: bf16-state fit {out['bf16']}", flush=True)
    del trainer, result
    trainer = Trainer(small, device=DEVICE, mesh=mesh)
    trainer.load_train_state(ckpt.load_train_state(job["one_process_dir"], "one", DEVICE))
    out["restored_digest"] = train_state_digest(torch, gathered_state(trainer))
    trainer.train_step(trainer.to_device(sb[1]))
    state = gathered_state(trainer)
    if rank == 0:
        ckpt.save_train_state(job["tp_dir"], state, "tp")
    out["saved_digest"] = train_state_digest(torch, state)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, test


def split_row_sums(torch, model) -> None:
    """Make a one-process model compute in tp=2's f32 order where tp=2 sums:
    each layer that tp=2 splits by its input (`proj`, `fc2`, `linear2`,
    `conv2`) adds the products of the two halves of its input, as the two
    ranks' partial sums add."""
    import torch.nn.functional as F

    from icl_tpu_torch.parallel.mesh import tp_plan

    plan, _ = tp_plan(model, 2)
    modules = dict(model.named_modules())
    for key, (dim, _) in plan.items():
        if dim != 1:
            continue
        m = modules[key.rsplit(".", 1)[0]]
        h = m.weight.shape[1] // 2
        if isinstance(m, torch.nn.Linear):
            def forward(x, m=m, h=h):
                y = F.linear(x[..., :h], m.weight[:, :h]) + F.linear(x[..., h:], m.weight[:, h:])
                return y if m.bias is None else y + m.bias
        else:
            def forward(x, m=m, h=h):
                kw = dict(stride=m.stride, padding=m.padding, dilation=m.dilation, groups=m.groups)
                y = (F.conv3d(x[:, :h], m.weight[:, :h], None, **kw)
                     + F.conv3d(x[:, h:], m.weight[:, h:], None, **kw))
                return y if m.bias is None else y + m.bias.view(1, -1, 1, 1, 1)
        m.forward = forward


def tp_swin_worker(torch, rank: int, world: int, port: int) -> dict:
    """Rank `rank` of SwinUNETR-ICL fs48 at 96^3 over tp=2 (phase 9's
    configuration at the job's batch; f32, TF32 off, recompute on): the
    heads each window-attention launch ran with; one step through
    `make_icl_step` (drop path off) and its control on the images times
    1 + 1e-7, gathered, on the trainer's model (drop path off throughout);
    then `Trainer` for TP_SWIN_STEPS steps from the same weights, timed,
    its launches and collectives; a validation on the held-out case on both
    ranks and the best model saved (gathered, written by rank 0). Then rank
    0 holds the step against the one-process step by phase 18's rule, the
    witness the one-process step in tp=2's f32 order (`split_row_sums`)."""
    import collections
    import dataclasses
    import gc

    import torch.distributed as dist

    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.data.synth import synthetic_brats_cases
    from icl_tpu_torch.models import layers
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.parallel.collectives import barrier, group_device
    from icl_tpu_torch.parallel.mesh import create_mesh, world_group
    from icl_tpu_torch.parallel.multihost import initialize_from_args
    from icl_tpu_torch.parallel.tensor import gather_tensors, param_splits
    from icl_tpu_torch.train.trainer import Trainer, brats_evaluator
    from icl_tpu_torch.utils import checkpoint as ckpt
    from icl_tpu_torch.utils.checkpoint import host_copy

    job = tp_job()
    batch_size = job["swin_batch"]
    initialize_from_args(f"127.0.0.1:{port}", world, rank, device=DEVICE)
    mesh = create_mesh(data=1, model=world, device=DEVICE)
    totals = instrument_all_reduce(torch, dist)
    heads = {"fwd": collections.Counter(), "bwd": collections.Counter()}
    fwd, bwd = wa.window_attention_fwd, wa.window_attention_bwd

    def fwd_heads(q, *args, **kwargs):
        heads["fwd"][q.shape[1]] += 1
        return fwd(q, *args, **kwargs)

    def bwd_heads(q, *args, **kwargs):
        heads["bwd"][q.shape[1]] += 1
        return bwd(q, *args, **kwargs)

    wa.window_attention_fwd, wa.window_attention_bwd = fwd_heads, bwd_heads
    cases = synthetic_brats_cases(4, CASE_SIZE, seed=0)
    held_out = synthetic_brats_cases(1, CASE_SIZE, seed=1)
    cfg = train_config("float32", TP_SWIN_STEPS, TP_SWIN_STEPS, "tp")
    cfg = dataclasses.replace(cfg, batch_size=batch_size, labeled_bs=batch_size // 2, log_flops=False)
    batches = brats_train_batches(cases, 2, len(cases), cfg.batch_size, cfg.labeled_bs,
                                  cfg.patch_size, seed=cfg.seed)
    batch = next(batches)

    def no_drop_path(model):
        for m in model.modules():
            if isinstance(m, layers.DropPath):
                m.rate = 0.0
        return model

    def step(model, scale=1.0):
        return unet_step(torch, model, batch, cfg.patch_size, DEVICE, scale, classes=2,
                         labeled=cfg.labeled_bs, consis=cfg.consis_weight)

    where = group_device(mesh.model_group)
    # the trainer's own model for the compared step too (drop path off in both)
    trainer = Trainer(cfg, device=DEVICE, mesh=mesh)
    model = no_drop_path(trainer.model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    splits = param_splits(model)
    before = host_copy(gather_tensors({n: p.detach() for n, p in model.named_parameters()}, splits,
                                      mesh, where))
    wa.reset_launch_counts()
    heads["fwd"].clear()
    heads["bwd"].clear()
    metrics, after = step(model)
    step_heads = {k: dict(v) for k, v in heads.items()}
    test = (metrics, host_copy(gather_tensors(after, splits, mesh, where)))
    model.load_state_dict(start)
    metrics, after = step(model, 1.0 + 1e-7)
    control = (metrics, host_copy(gather_tensors(after, splits, mesh, where)))
    model.load_state_dict(start)
    model.zero_grad(set_to_none=True)
    del model, start, after
    gc.collect()
    torch.cuda.empty_cache()

    steps = []
    trainer.step_fn = timed_steps(torch, trainer.step_fn, totals, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    heads["fwd"].clear()
    heads["bwd"].clear()
    mark = dict(totals)
    for _ in range(TP_SWIN_STEPS):
        trainer.train_step(trainer.to_device(next(batches)))
    torch.cuda.synchronize()
    per_steps = {"fwd": dict(wa.window_attention.launches_by_mode),
                 "bwd": dict(wa.window_attention_bwd.launches_by_mode),
                 "heads": {k: dict(v) for k, v in heads.items()},
                 "collectives": per_step_collectives(totals, mark, TP_SWIN_STEPS)}
    peak = torch.cuda.max_memory_allocated()
    trainer.model.eval()
    wa.reset_launch_counts()
    t0 = time.perf_counter()
    agg = brats_evaluator(held_out, 2, cfg.patch_size, trainer.device)(trainer.model)
    val_s = time.perf_counter() - t0
    val_launches = launches_now(wa)
    best_path = ckpt.save_best_model(cfg.snapshot_path, trainer.model)
    out = {"step_heads": step_heads, "per_steps": per_steps, "val_launches": val_launches,
           "peak_bytes": peak, "steps": steps, "mean_dice": agg["mean_dice"], "val_s": val_s,
           "best_path": best_path, "batch": batch_size}
    print(f"[tp-swin] rank {rank}: steps {steps}; peak memory {peak / 2**30:.2f} GiB; collectives "
          f"per step {per_steps['collectives']}; launches by heads of one step {step_heads}; "
          f"validation {agg['mean_dice']!r} in {val_s:.2f} s", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    barrier(world_group())
    dist.destroy_process_group()
    if rank == 0:
        wa.window_attention_fwd, wa.window_attention_bwd = fwd, bwd
        model = no_drop_path(net_factory("swinunetr_icl", 1, 2, device=DEVICE,
                                         feature_size=FEATURE_SIZE, patch_size=PATCH, remat=True,
                                         generator=torch.Generator().manual_seed(cfg.seed)))
        start = {k: v.clone() for k, v in model.state_dict().items()}
        metrics, after = step(model)
        reference = (metrics, host_copy(after))
        model.load_state_dict(start)
        split_row_sums(torch, model)
        metrics, after = step(model)
        runs = {"test": test, "reference": reference, "control": control,
                "witness": (metrics, host_copy(after))}
        step_agreement(torch, "[tp-swin]", f"one SwinUNETR-ICL fs{FEATURE_SIZE} step at {PATCH}^3, "
                       f"batch {batch_size}, tp=2 vs 1 process (rule: phase 18 over the parameters, "
                       "gathered; control = the tp=2 step on the images times 1 + 1e-7; witness = the "
                       "one-process step with tp=2's row-parallel sums split in two)", before, runs)
    return out


def tp_dp_worker(torch, rank: int, world: int, port: int) -> dict:
    """Rank `rank` of the flagship over dp2 x tp2 (4 ranks) at the job's side
    (256^2 when four ranks' peaks fit the card, else 128^2), batch 16 of
    which 8 labeled, f32, zero_stochastic: TP_DP_STEPS steps on its data
    rank's rows, timed with their collectives; the digests of its replicated
    leaves and of its model group's gathered state; the first step's loss
    terms."""
    import dataclasses

    import torch.distributed as dist

    from icl_tpu_torch.data.synth import synthetic_acdc
    from icl_tpu_torch.parallel.collectives import barrier
    from icl_tpu_torch.parallel.mesh import create_mesh, world_group
    from icl_tpu_torch.parallel.multihost import host_slice, initialize_from_args
    from icl_tpu_torch.train.trainer import Trainer

    side = tp_job()["dp_side"]
    initialize_from_args(f"127.0.0.1:{port}", world, rank, device=DEVICE)
    mesh = create_mesh(data=world // 2, model=2, device=DEVICE)
    torch.backends.cudnn.deterministic = True
    totals = instrument_all_reduce(torch, dist)
    slices, _ = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D, CLASSES_2D, seed=0)
    cfg = dataclasses.replace(unet_config(30000, 0, "tp_dp", side=side, zero_stochastic=True),
                              log_flops=False)
    batches = [b for _, b in zip(range(TP_DP_STEPS), acdc_batches(slices, cfg))]
    trainer = Trainer(cfg, device=DEVICE, mesh=mesh)
    steps = []
    trainer.step_fn = timed_steps(torch, trainer.step_fn, totals, steps)
    mark = dict(totals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = {}
    for i, b in enumerate(batches):
        vec = trainer.train_step(trainer.to_device(host_slice(b, cfg.labeled_bs, mesh.rank, mesh.size)))
        metrics.update({f"{k}@{i + 1}": v for k, v in zip(trainer.metric_keys, vec.tolist())})
    torch.cuda.synchronize()
    out = {"mesh": [mesh.rank, mesh.size, mesh.model_rank, mesh.model_size], "side": side,
           "steps": steps, "metrics": metrics, "peak_bytes": torch.cuda.max_memory_allocated(),
           "collectives": per_step_collectives(totals, mark, TP_DP_STEPS),
           "replicated": replicated_digest(torch, trainer), "digest": state_digest(torch, trainer)}
    print(f"[tp-dp] rank {rank} (data {mesh.rank}, model {mesh.model_rank}) at {side}^2: steps {steps}; "
          f"peak memory {out['peak_bytes'] / 2**30:.2f} GiB; collectives per step {out['collectives']}",
          flush=True)
    barrier(world_group())
    dist.destroy_process_group()
    return out


def phase_tp_rule_table(torch) -> dict:
    """47: the rule table at full width, M = 2, on models built on the meta
    device: every sharded leaf's whole and local shape, the layers left
    replicated, and each rank's parameter bytes (f32)."""
    from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL
    from icl_tpu_torch.models.unet2d_icl import UNetICL
    from icl_tpu_torch.parallel.mesh import tp_plan

    out = {}
    for name, make in (("icl_unet_256", lambda: UNetICL(1, CLASSES_2D, patch_size=IMG_UNET)),
                       ("swinunetr_icl_fs48", lambda: SwinUNETRICL(1, 2, img_size=PATCH,
                                                                   feature_size=FEATURE_SIZE))):
        with torch.device("meta"):
            model = make()
        plan, replicated = tp_plan(model, 2)
        leaves = {}
        rank_bytes = 0
        whole_bytes = 0
        for key, p in model.named_parameters():
            shape = list(p.shape)
            whole_bytes += p.numel() * 4
            if key in plan:
                local = list(shape)
                local[plan[key][0]] //= 2
                leaves[key] = [shape, local]
                rank_bytes += math.prod(local) * 4
            else:
                rank_bytes += p.numel() * 4
        out[name] = {"sharded": len(leaves), "rank_bytes": rank_bytes, "whole_bytes": whole_bytes,
                     "replicated_layers": replicated}
        print(f"[tp-rules] {name} at M = 2: {len(leaves)} sharded leaves [whole, local] "
              f"{json.dumps(leaves)}; layers left replicated {replicated}; parameter bytes per rank "
              f"{rank_bytes} of {whole_bytes} (f32)", flush=True)
        if not leaves:
            fail(f"[tp-rules] {name}: nothing sharded")
    return out


def phase_tp_local_kernels(torch, wa) -> list:
    """49 (kernels): the forward and backward kernels at the local shapes of
    the SwinUNETR-ICL fs48 training step over tp=2 (each stage's heads over
    2, stage 1's 3 whole), f32 and bf16, against their plain versions and
    bitwise repeatable."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = []
    scale = HEAD_DIM ** -0.5
    for stage in STAGES:
        name, _, padded, ws, shift, heads = stage
        local = (name, LABELED_BS, padded, ws, shift, local_heads_of(heads))
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias, ids = stage_inputs(torch, local, dtype, gen)
                ids = ids if mode == "region" else None
                g = torch.randn(q.shape, device=DEVICE, generator=gen).to(dtype)
                out, again = (wa.window_attention(q, k, v, bias, ids, scale=scale) for _ in range(2))
                grads, grads2 = (wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)
                                 for _ in range(2))
                torch.cuda.synchronize()
                want = wa.window_attention_plain(q, k, v, bias, ids, scale=scale)
                want_grads = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale)
                err = (out.float() - want.float()).abs()
                if dtype == torch.float32:
                    fwd_ok = float(err.max()) <= F32_ATOL
                else:
                    fwd_ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
                names = ("dq", "dk", "dv", "dbias")
                errs = {n: rel_err(a, b) for n, a, b in zip(names, grads, want_grads)}
                tols = {n: BWD_F32_RTOL if dtype == torch.float32 or n == "dbias" else BWD_BF16_RTOL
                        for n in names}
                row = {"stage": name, "mode": mode, "dtype": str(dtype).split(".")[-1],
                       "shape": list(q.shape), "fwd_max_abs_err": float(err.max()),
                       "bwd_rel_err": errs, "bitwise_repeat": torch.equal(out, again)
                       and all(torch.equal(a, b) for a, b in zip(grads, grads2))}
                rows.append(row)
                if not fwd_ok or any(errs[n] > tols[n] for n in names) or not row["bitwise_repeat"]:
                    fail(f"[tp-kernels] a kernel disagrees at a local shape: {row}")
    print(f"[tp-kernels] forward and backward kernels at the tp=2 local shapes, against plain, "
          f"bitwise repeatable: {json.dumps(rows)}", flush=True)
    torch.cuda.empty_cache()
    return rows


def phase_tp_local_times(torch, F, wa) -> list:
    """53 (kernel times): phase 49's tp=2 local shapes, f32, timed on the
    idle card (phase 49 checks them while its ranks run): each kernel
    beside the bound, its plain version and SDPA (forward, and the
    backward of q, k, v and the mask)."""
    gen = torch.Generator(device=DEVICE).manual_seed(49)
    scale = HEAD_DIM ** -0.5
    rows = []
    for name, _, padded, ws, shift, heads in STAGES:
        local = (name, LABELED_BS, padded, ws, shift, local_heads_of(heads))
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            q, k, v, bias, ids = stage_inputs(torch, local, torch.float32, gen)
            ids = ids if mode == "region" else None
            g = torch.randn(q.shape, device=DEVICE, generator=gen)
            B, H, N, D = q.shape
            dense = wa.mask_from_region_ids(ids) if ids is not None else None
            if ids is None:
                attn, qs, ks, vs = bias, q, k, v
            else:
                nW = ids.shape[0]
                attn = bias[None] + dense[:, None]
                qs, ks, vs = (t.view(B // nW, nW, H, N, D) for t in (q, k, v))
            mask_floats = ids.numel() if ids is not None else 0
            row = {"stage": name, "mode": mode, "shape": list(q.shape), "fwd": dict(
                ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, ids, scale=scale)),
                plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, scale=scale)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=attn, scale=scale)),
                **bound_fields(*bound(B, H, N, D, mask_floats))), "bwd": dict(
                ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)),
                plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                    q, k, v, bias, ids, g, scale=scale), reps=3),
                library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, dense, g, scale),
                **bound_fields(*bound(B, H, N, D, mask_floats, backward=True)))}
            rows.append(row)
            print(f"[tp-kernel-times] {json.dumps(row)}", flush=True)
            del q, k, v, bias, g, attn, qs, ks, vs, dense
            torch.cuda.empty_cache()
    return rows


def phase_tp_sgd_shards(torch, sg) -> dict:
    """51 (kernel): the SR kernel on each rank's shard of the flagship's
    largest leaves (`mlp2` fc1 rows, fc2 columns, its bias) and of an
    `fc_kv` weight (two pieces of heads) equals the matching slice of the
    kernel's whole-leaf update, bit for bit."""
    from icl_tpu_torch.parallel.tensor import Split
    from icl_tpu_torch.train.optim import shard_runs

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    lr = torch.tensor(0.01, device=DEVICE)
    count = torch.tensor(7, dtype=torch.int64, device=DEVICE)
    cases = {"mlp2.fc1.weight": ((16384, 16384), 0, 1), "mlp2.fc2.weight": ((16384, 16384), 1, 1),
             "mlp2.fc1.bias": ((16384,), 0, 1), "attn.fc_kv.weight": ((256, 128), 0, 2)}
    out = {}
    launches = sg.sgd_bf16_update.launches
    for name, (shape, dim, pieces) in cases.items():
        p, g, buf = (torch.randn(shape, device=DEVICE, generator=gen).bfloat16() for _ in range(3))
        whole = tuple(t.clone() for t in (p, g, buf))
        sg.sgd_bf16_update(*whole, lr, count, 0.9, 1e-4, 11, 5)
        equal = []
        for r in range(2):
            split = Split(dim, shape[dim], pieces, r, 2)
            shard = tuple(split.take(t) for t in (p, g, buf))
            for run, offset, cols, stride in shard_runs(split, shard):
                sg.sgd_bf16_update(*run, lr, count, 0.9, 1e-4, 11, 5, offset, cols, stride)
            equal.append(torch.equal(shard[0].view(torch.int16), split.take(whole[0]).view(torch.int16))
                         and torch.equal(shard[2].view(torch.int16),
                                         split.take(whole[2]).view(torch.int16)))
        out[name] = equal
        del p, g, buf, whole
    sg.sgd_bf16_update.launches = launches  # checks, not the path
    torch.cuda.empty_cache()
    print(f"[tp-sgd] the SR kernel on each rank's shard against the slice of its whole-leaf update, "
          f"bit for bit (ranks 0, 1): {out}", flush=True)
    if not all(all(v) for v in out.values()):
        fail("[tp-sgd] a shard's update differs from the slice of the whole leaf's")
    return out


def tp_prepare(torch, swin_peak) -> dict:
    """Before phase 42, whose ranks run phase 48: the one-process save at
    TP_SMALL_SIDE that the tp=2 ranks restore (52), its digest and first
    step's loss terms, and the job file of the tensor-parallel workers
    (SwinUNETR-ICL's batch: 2 where two of phase 9's peaks would not fit
    the card)."""
    import gc

    from icl_tpu_torch.data.synth import synthetic_acdc
    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils import checkpoint as ckpt

    shutil.rmtree(TP_ROOT, ignore_errors=True)
    os.makedirs(TP_ROOT, exist_ok=True)
    slices, _ = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D, CLASSES_2D, seed=0)
    small = unet_config(30000, 0, "tp_small", side=TP_SMALL_SIDE, zero_stochastic=True)
    sb = [b for _, b in zip(range(2), acdc_batches(slices, small))]
    one = Trainer(small, device=DEVICE)
    vec = one.train_step(one.to_device(sb[0]))
    job = {"one_process_dir": os.path.join(TP_ROOT, "one"), "tp_dir": os.path.join(TP_ROOT, "tp"),
           "swin_batch": TRAIN_BATCH, "dp_side": IMG_UNET}
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    if swin_peak and 2 * swin_peak > 0.9 * card_bytes:
        job["swin_batch"] = 2
    ckpt.save_train_state(job["one_process_dir"], one.train_state(), "one")
    prep = {"job": job, "small_first": dict(zip(one.metric_keys, vec.tolist())),
            "one_digest": train_state_digest(torch, one.train_state()), "card_bytes": card_bytes}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(TP_ROOT, "job.json"), "w") as f:
        json.dump(job, f)
    return prep


def phase_tensor_parallel(torch, wa, sg, held_out, prep: dict, flagship: list) -> dict:
    """47-52: tensor parallelism on the card (see the module docstring);
    `flagship` holds the two ranks' tp=2 numbers from phase 42's worker."""
    import gc

    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils import checkpoint as ckpt

    t_all = time.perf_counter()
    # the SwinUNETR-ICL ranks start now; while they start and build, this
    # process checks the rule table, the flagship's numbers, the restores,
    # the SR shards and the kernels at the local shapes (no timing here)
    swin_run = start_ranks("tp-swin", 2)
    rules = phase_tp_rule_table(torch)
    job, card_bytes, one_digest = prep["job"], prep["card_bytes"], prep["one_digest"]
    small = unet_config(30000, 0, "tp_small", side=TP_SMALL_SIDE, zero_stochastic=True)
    tp_dir = job["tp_dir"]
    f0, f1 = flagship
    for r in (f0, f1):
        if r["runs"][0]["digest"] != r["runs"][1]["digest"] or r["runs"][0]["metrics"] != r["runs"][1]["metrics"]:
            fail("[tp-flagship] the eager repeat of the tp=2 steps differs")
        if any(n for counts in r["attention"].values() for n in counts.values()):
            fail(f"[tp-flagship] the U-Net path launched window attention: {r['attention']}")
        if r["bf16"]["launches"] != r["bf16"]["expected"] or not all(math.isfinite(x) for x in r["bf16"]["losses"]):
            fail(f"[tp-flagship] the bf16-state fit: {r['bf16']}")
    if f0["runs"][0]["replicated"] != f1["runs"][0]["replicated"]:
        fail("[tp-flagship] the two ranks' replicated leaves differ")
    if f0["runs"][0]["metrics"] != f1["runs"][0]["metrics"]:
        fail("[tp-flagship] the two ranks logged different losses")
    if f0["restored_digest"] != one_digest or f1["restored_digest"] != one_digest:
        fail("[tp-restore] the one-process save restored at tp=2 is not the saved state bit for bit")
    back = Trainer(small, device=DEVICE)
    back.load_train_state(ckpt.load_train_state(tp_dir, "tp", DEVICE))
    back_digest = train_state_digest(torch, back.train_state())
    del back
    gc.collect()
    torch.cuda.empty_cache()
    if back_digest != f0["saved_digest"]:
        fail("[tp-restore] the tp=2 save restored at tp=1 is not the saved state bit for bit")
    peaks = [r["runs"][0]["peak_bytes"] for r in (f0, f1)]
    steps = [[round(s["seconds"], 4) for s in r["runs"][0]["steps"]] for r in (f0, f1)]
    print(f"[tp-flagship] U-Net-ICL 2D at {IMG_UNET}^2 over tp=2 on the card (gloo), {DP_STEPS} f32 "
          f"steps twice, bitwise equal; replicated leaves bitwise equal across the ranks; s/step per "
          f"rank {steps} (s/step after the first, rank 0: "
          f"{sum(steps[0][1:]) / (DP_STEPS - 1):.4f}); collectives per step and rank "
          f"{[r['runs'][0]['collectives'] for r in (f0, f1)]}; peak memory per rank "
          f"{[round(p / 2**30, 2) for p in peaks]} GiB; parameter bytes per rank "
          f"{[r['param_bytes'] for r in (f0, f1)]}; build and shard {[round(r['build_s'], 1) for r in (f0, f1)]} s; "
          f"bf16-state fit SR launches per rank {[r['bf16']['launches'] for r in (f0, f1)]} "
          f"({f0['bf16']['leaves']} leaves); restores bit for bit both ways at {TP_SMALL_SIDE}^2",
          flush=True)
    sgd = phase_tp_sgd_shards(torch, sg)

    # 49: SwinUNETR-ICL fs48 over tp=2
    kernels = phase_tp_local_kernels(torch, wa)
    s0, s1 = finish_ranks(swin_run, 1200)
    swin_s = time.perf_counter() - t_all
    per_stage = {"fwd": {}, "bwd": {}}
    for st in STAGES:
        n = sum(PER_FORWARD[m].get(st[0], 0) for m in ("none", "region"))
        h = local_heads_of(st[5])
        per_stage["bwd"][h] = per_stage["bwd"].get(h, 0) + 2 * n
        per_stage["fwd"][h] = per_stage["fwd"].get(h, 0) + 4 * n
    for r in (s0, s1):
        got = {k: {int(h): n for h, n in v.items()} for k, v in r["step_heads"].items()}
        if got != per_stage:
            fail(f"[tp-swin] launches by heads of one step {got}, reckoned {per_stage}")
        want = {"fwd": FWD_PER_STEP, "bwd": BWD_PER_STEP}
        for kind in ("fwd", "bwd"):
            if r["per_steps"][kind] != {**{m: TP_SWIN_STEPS * n for m, n in want[kind].items()}, "mask": 0}:
                fail(f"[tp-swin] {kind} launches over {TP_SWIN_STEPS} steps {r['per_steps'][kind]}")
        if not any(r["val_launches"]["fwd"].values()) or any(r["val_launches"]["bwd"].values()):
            fail(f"[tp-swin] the validation's launches {r['val_launches']}")
    if not os.path.exists(s0["best_path"]):
        fail("[tp-swin] no best model was saved")
    # index_add_ stitches the patches with atomics on the card: the two ranks'
    # maps may part at near-ties
    if abs(s0["mean_dice"] - s1["mean_dice"]) > TP_DICE_ATOL:
        fail(f"[tp-swin] the ranks' validations differ: {s0['mean_dice']!r}, {s1['mean_dice']!r}")
    s_per_step = [sum(st["seconds"] for st in r["steps"][1:]) / (TP_SWIN_STEPS - 1) for r in (s0, s1)]
    print(f"[tp-swin] SwinUNETR-ICL fs{FEATURE_SIZE} at {PATCH}^3, batch {s0['batch']}, over tp=2: "
          f"{[round(x, 4) for x in s_per_step]} s/step after the first, peak memory per rank "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in (s0, s1)]} GiB, collectives per step "
          f"{[r['per_steps']['collectives'] for r in (s0, s1)]}, launches per rank over "
          f"{TP_SWIN_STEPS} steps {s0['per_steps']['fwd']} forward, {s0['per_steps']['bwd']} "
          f"backward, by heads per step {s0['step_heads']} (reckoned {per_stage}); the validation "
          f"on both ranks in {[round(r['val_s'], 2) for r in (s0, s1)]} s, launching "
          f"{[r['val_launches']['fwd'] for r in (s0, s1)]} forward; {swin_s:.1f} s", flush=True)
    # 50: the flagship over dp2 x tp2, 256^2 when four ranks' peaks fit the
    # card; its ranks start before the one-process eval of the tp=2 run
    side = IMG_UNET if 4 * max(peaks) <= 0.9 * card_bytes else TP_SMALL_SIDE
    job["dp_side"] = side
    with open(os.path.join(TP_ROOT, "job.json"), "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    dp_run = start_ranks("tp-dp", 4)
    # 50 (eval): the stripped best checkpoint, one process, against the tp=2 validation
    from icl_tpu_torch.eval.infer3d import evaluate_brats_cases, make_patch_predictor
    from icl_tpu_torch.metrics import aggregate_case_metrics
    from icl_tpu_torch.scripts.test_3D_BraTS import load_eval_model

    model = load_eval_model("swinunetr_icl", s0["best_path"], 2, DEVICE, FEATURE_SIZE)
    agg = aggregate_case_metrics(evaluate_brats_cases(
        make_patch_predictor(model), held_out, 2, (PATCH,) * 3, STRIDE, STRIDE, sw_batch=SW_BATCH,
        device=DEVICE))
    val_dice = s0["mean_dice"]
    print(f"[tp-eval] the tp=2 run's stripped best checkpoint, loaded strictly into "
          f"{type(model).__name__} in one process: mean dice {agg['mean_dice']!r}, the tp=2 "
          f"validation {val_dice!r} (tolerance {TP_DICE_ATOL})", flush=True)
    if abs(agg["mean_dice"] - val_dice) > TP_DICE_ATOL:
        fail("[tp-eval] the one-process eval does not give the tp=2 validation dice")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    dps = finish_ranks(dp_run, 900)
    dp_s = time.perf_counter() - t0
    if [r["mesh"] for r in dps] != [[0, 2, 0, 2], [0, 2, 1, 2], [1, 2, 0, 2], [1, 2, 1, 2]]:
        fail(f"[tp-dp] the mesh {[r['mesh'] for r in dps]}")
    # the replicated leaves equal on all four ranks, each shard on both data ranks
    if len({r["replicated"] for r in dps}) != 1 or any(
            dps[m]["digest"] != dps[2 + m]["digest"] for m in (0, 1)):
        fail("[tp-dp] the replicas differ across the ranks")
    first_ref = f0["one_process_first"] if side == IMG_UNET else prep["small_first"]
    first = {k: abs(dps[0]["metrics"][f"{k}@1"] - v) / max(abs(v), 1e-12) for k, v in first_ref.items()}
    print(f"[tp-dp] U-Net-ICL 2D over dp2 x tp2 (4 ranks on the card, gloo) at {side}^2 (four tp=2 "
          f"peaks of {max(peaks) / 2**30:.2f} GiB against the card's {card_bytes / 2**30:.1f} GiB): "
          f"replicas bitwise equal; the first step's loss terms against one process, largest relative "
          f"error {max(first.values()):.3e} (tolerance {DP_METRIC_RTOL}); s/step per rank "
          f"{[[round(s['seconds'], 4) for s in r['steps']] for r in dps]}; collectives per step "
          f"{[r['collectives'] for r in dps]}; peak memory per rank "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in dps]} GiB; {dp_s:.1f} s", flush=True)
    if max(first.values()) > DP_METRIC_RTOL:
        fail("[tp-dp] the first step's loss terms disagree with one process")
    shutil.rmtree(TP_ROOT, ignore_errors=True)
    print(f"[summary] tensor-parallel phases 47-52 in {time.perf_counter() - t_all:.1f} s", flush=True)
    return {"rules": rules, "flagship": {"steps": steps, "peaks": peaks,
                                         "collectives": [r["runs"][0]["collectives"] for r in (f0, f1)],
                                         "param_bytes": [r["param_bytes"] for r in (f0, f1)],
                                         "first_step_rel_err": f0["first_step_rel_err"],
                                         "sgd_bf16_launches": [r["bf16"]["launches"] for r in (f0, f1)]},
            "swin": {"s_per_step": s_per_step, "peaks": [r["peak_bytes"] for r in (s0, s1)],
                     "collectives": [r["per_steps"]["collectives"] for r in (s0, s1)],
                     "launches": [{k: r["per_steps"][k] for k in ("fwd", "bwd")} for r in (s0, s1)],
                     "val_launches": [r["val_launches"] for r in (s0, s1)], "val_dice": val_dice,
                     "eval_dice": agg["mean_dice"], "batch": s0["batch"]},
            "dp": {"side": side, "steps": [r["steps"] for r in dps],
                   "peaks": [r["peak_bytes"] for r in dps],
                   "collectives": [r["collectives"] for r in dps]},
            "kernels": kernels, "sgd": sgd}


DP_WORKERS.update({"tp-swin": tp_swin_worker, "tp-dp": tp_dp_worker})


# 53: ACDC-like slice sizes (odd and even sides, square and not, 154 to 512
# pixels) and the patch sides of the 2D paths
NATIVE_SLICE_SIZES = [(256, 216), (255, 255), (213, 177), (232, 256), (154, 224), (428, 512), (201, 199)]
NATIVE_ZOOM_SIDES = (IMG_UNET, IMG_2D, IMG_SWIN_SUP)


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (x86: the model name, vendor,
    family, model and stepping; Arm: the implementer and part) and the
    count of its cores."""
    fields, cores = {}, 0
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            cores += key == "processor"
            fields.setdefault(key, value.strip())
    keys = (("model name", "vendor_id", "cpu family", "model", "stepping") if "vendor_id" in fields
            else ("CPU implementer", "CPU part", "CPU variant"))
    return ", ".join(f"{k} {fields.get(k)}" for k in keys) + f"; {cores} cores"


def build_host_helper() -> dict:
    """2 (host): the port's C++ order-0 zoom and rotate built with the
    host's compiler (`icl_tpu_torch.native`), beside the nvcc builds."""
    from icl_tpu_torch import native
    from icl_tpu_torch.ops import build

    t0 = time.perf_counter()
    if not native.available():
        fail("no C++ compiler on the card's host: the host batches would run in scipy")
    build_s = time.perf_counter() - t0
    path, _ = build.build_host_library(native.SOURCE, build.find_cxx())
    return {"library": os.path.relpath(path, ROOT), "compiler": build.find_cxx(),
            "flags": " ".join(build.CXX_FLAGS), "build_s": build_s, "cpu": host_cpu()}


def phase_native_helper(host_build: dict) -> dict:
    """53: the port's C++ order-0 zoom and rotate on the card's host: built
    in phase 2 (its seconds, the host CPU); against scipy.ndimage pixel for
    pixel, f32 and u8, every rotation by the 40 integer angles the
    augmentation draws and every zoom to the 2D paths' patch sides, at the
    ACDC slice sizes; ms per call, the library against scipy."""
    import numpy as np
    from scipy import ndimage

    from icl_tpu_torch import native

    if not native.available():
        fail("[native] the library is not available")
    rng = np.random.default_rng(53)
    differ, calls = {}, 0
    for h, w in NATIVE_SLICE_SIZES:
        image = rng.standard_normal((h, w)).astype(np.float32)
        label = rng.integers(0, 4, (h, w)).astype(np.uint8)
        for kind, x in (("f32", image), ("u8", label)):
            n = sum(int(np.count_nonzero(native.rotate_nearest(x, a)
                                         != ndimage.rotate(x, a, order=0, reshape=False)))
                    for a in range(-20, 20))
            n += sum(int(np.count_nonzero(native.zoom_nearest(x, (side, side))
                                          != ndimage.zoom(x, (side / h, side / w), order=0)))
                     for side in NATIVE_ZOOM_SIDES)
            differ[f"{h}x{w} {kind}"] = n
            calls += 40 + len(NATIVE_ZOOM_SIDES)
    h, w = NATIVE_SLICE_SIZES[0]
    image = rng.standard_normal((h, w)).astype(np.float32)
    label = rng.integers(0, 4, (h, w)).astype(np.uint8)
    side = IMG_UNET

    def ms(fn, reps: int) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    per_call = {}
    for kind, x in (("f32", image), ("u8", label)):
        per_call[f"zoom {h}x{w} to {side}^2 {kind}"] = {
            "native_ms": ms(lambda: native.zoom_nearest(x, (side, side)), 200),
            "scipy_ms": ms(lambda: ndimage.zoom(x, (side / h, side / w), order=0), 50)}
        per_call[f"rotate {h}x{w} by 13 {kind}"] = {
            "native_ms": ms(lambda: native.rotate_nearest(x, 13), 100),
            "scipy_ms": ms(lambda: ndimage.rotate(x, 13, order=0, reshape=False), 20)}
    result = {**host_build, "checked_calls": calls, "differing_pixels": sum(differ.values()),
              "ms_per_call": per_call}
    print(f"[native] {json.dumps(result)}; differing pixels by size {json.dumps(differ)}", flush=True)
    if any(differ.values()):
        fail(f"[native] the library differs from scipy: {differ}")
    return result


# Phases 54-56: SwinUNETR at a feature size other than 48 (MONAI's default
# 24: head dim 8 at every stage, heads 3-6-12-24), which the kernels run at
# their tile of 16 with zero columns; the head dims of other feature sizes
# at the stage-1 shapes; the bf16 state with recompute. (The Swin ICL
# models' fused sspa pair is checked in phases 10 and 15.)
FS24 = 24
HEAD_DIM_FS24 = FS24 // 3
# head dims held and timed at the stage-1 shapes: fs12 and fs36, the
# smallest and largest of the first tile's below 16 that a path calls; the
# card's tests hold every other head dim in every mode (fs30's 10, not a
# multiple of 4, and the tile of 32's 20 and 28 left this sweep to make
# room for the time of phases 57-58)
SWEEP_HEAD_DIMS = (4, 12)
TIMED_SWEEP_HEAD_DIMS = (4, 12)
# tests/test_torch_window_attention_card.py's HEAD_DIMS, every mode, run
# beside phase 39
CARD_TEST_HEAD_DIMS = (1, 4, 7, 8, 10, 12, 16, 20, 24, 28, 32, 33, 40, 48, 63, 64, 65, 72, 80, 96, 127, 128)
# and its STREAM_HEAD_DIMS, the streamed kernels' (every mode, N 4 to 343)
CARD_TEST_STREAM_HEAD_DIMS = (129, 144, 192, 256, 320)


def phase_kernels_head_dims(torch, F, wa) -> dict:
    """54: both kernels at fs24's shapes (head dim 8: the four stages of one
    inference forward at sw_batch 4, stage 1 [1372, 3, 343, 8], and of one
    training pass at batch 2, [686, 3, 343, 8]), no-mask and region ids,
    f32 and bf16, bitwise repeatable, f32 timed beside the bound, the plain
    version and SDPA; then head dims 4 and 12 at the stage-1 shapes, held,
    repeated and timed."""
    fwd = phase_kernel_3d(torch, F, wa, head_dim=HEAD_DIM_FS24, tag="[kernel-fs24]")
    bwd = phase_backward_kernel(torch, F, wa, head_dim=HEAD_DIM_FS24, tag="[bwd-fs24]")
    sweep = {"fwd": [], "bwd": []}
    for d in SWEEP_HEAD_DIMS:
        timed = d in TIMED_SWEEP_HEAD_DIMS
        sweep["fwd"] += phase_kernel_3d(torch, F, wa, head_dim=d, stages=STAGES[:1], timed=timed,
                                        tag=f"[kernel-d{d}]")
        sweep["bwd"] += phase_backward_kernel(torch, F, wa, head_dim=d, stages=STAGES[:1], timed=timed,
                                              tag=f"[bwd-d{d}]")
    largest = {d: max(r["max_abs_err"] for r in sweep["fwd"] + sweep["bwd"] if r["shape"][3] == d)
               for d in SWEEP_HEAD_DIMS}
    print(f"[head-dims] stage-1 shapes held at head dims {list(SWEEP_HEAD_DIMS)} (forward and backward, "
          f"no-mask and region ids, f32 and bf16, bitwise repeatable): the largest abs error at each "
          f"{json.dumps(largest)}", flush=True)
    return {"fwd": fwd, "bwd": bwd, "sweep": sweep}


def phases_54_56(torch, F, wa, sg, cases, held_out) -> dict:
    """54-56 on phase 9's cases."""
    t0 = time.perf_counter()
    kernels = phase_kernels_head_dims(torch, F, wa)
    fs24 = phase_fs24_cli(torch, wa, cases, held_out)
    bf16_remat = phase_bf16_remat(torch, wa, sg, cases)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    print(f"[summary] phases 54-56 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({'fs24': {k: fs24[k] for k in ('s_per_step', 'peak_bytes', 'val_dice')}, 'bf16_remat': bf16_remat})}",
          flush=True)
    return {"kernels": kernels, "fs24": fs24, "bf16_remat": bf16_remat}


def phase_fs24_cli(torch, wa, cases, held_out) -> dict:
    """55: SwinUNETR-ICL at --feature_size 24 through its CLI's `main` on
    phase 9's cases (96^3, batch 4 of which 2 labeled, f32 with TF32 off,
    recompute on), 3 steps and a validation, the launches per step
    asserted as phase 9's; test_3D_BraTS --model swinunetr_icl
    --feature_size 24 on the stripped best checkpoint gives the
    validation dice."""
    return feature_size_cli(torch, wa, cases, held_out, FS24)


def feature_size_cli(torch, wa, cases, held_out, fs: int, precision: str | None = "float32") -> dict:
    """SwinUNETR-ICL at --feature_size `fs` through its CLI's `main` (phase
    55's run) at `precision` (None: the CLI's default, bf16 autocast),
    timing the Trainer's model build (the weights drawn on the host and
    moved to the card); test_3D_BraTS on the best checkpoint."""
    from icl_tpu_torch.scripts import test_3D_BraTS
    from icl_tpu_torch.scripts import train_inherent_consistent_swinunetr_3D_BraTS as cli
    from icl_tpu_torch.train import trainer as trainer_module
    from icl_tpu_torch.train.steps import METRIC_KEYS

    data = InMemoryDataset(cases, held_out)
    tag = f"[fs{fs}]"
    common = ["--root_path", "in-memory-BraTS", "--exp", f"BraTS_chip_smoke/ICL_fs{fs}", "--num_tries",
              f"fs{fs}", "--labeled_num", "2", "--feature_size", str(fs)]
    built = {}
    factory = trainer_module.net_factory

    def timed_factory(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = factory(*args, **kwargs)
        torch.cuda.synchronize()
        built.setdefault("build_s", time.perf_counter() - t0)
        built.setdefault("n_params", sum(p.numel() for p in model.parameters()))
        return model

    trainer_module.net_factory = timed_factory
    torch.manual_seed(0)  # drop-path masks
    try:
        run = run_cli(torch, wa, cli, common + ["--total_num", str(len(cases)), "--max_iterations",
                                                str(TRAIN_STEPS), "--val_interval", str(TRAIN_STEPS)]
                      + (["--precision", precision] if precision else []),
                      "BraTS2019Dataset", data, tag, METRIC_KEYS, TRAIN_STEPS,
                      {"fwd": FWD_PER_STEP, "bwd": BWD_PER_STEP})
    finally:
        trainer_module.net_factory = factory
    run.update(built)
    print(f"{tag} SwinUNETR-ICL fs{fs} ({precision or 'the CLI default precision'}): {built['n_params']} "
          f"parameters, the Trainer's model built in "
          f"{built['build_s']:.2f} s; {run['s_per_step']:.4f} s/step, peak memory "
          f"{run['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    eval_dice = eval_cli(test_3D_BraTS, common + ["--model", "swinunetr_icl"], "BraTS2019Dataset", data)
    print(f"[eval-fs{fs}] test_3D_BraTS --model swinunetr_icl --feature_size {fs} on the best "
          f"checkpoint: mean dice {eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail(f"test_3D_BraTS does not reproduce the fs{fs} SwinUNETR-ICL's validation dice")
    return run


def fused_pair_agreement(torch, wa, model, batch, patch, tag: str, **step_kw) -> None:
    """One f32 step of `model` (drop path off) with the fused sspa pair
    against the two-call step from the same state, by phase 10's rule over
    every parameter: the fused step on the batch times 1 + 1e-7 is the
    control, and, as in phase 42, the witness is per tensor the farthest
    from the two-call step of two two-call steps that compute the same
    step in exact arithmetic and another one in f32 (the batch times
    1 - 1e-7; each branch's rows reversed). The fused pair runs the heads'
    `mlp2` over both branches' rows in one product, so it sums their
    gradients in another f32 order, and behind the heads' BatchNorms (near
    constant attention maps at random weights) f32 rounding moves those
    gradients past the fixed allowance under any such change."""
    import gc

    import numpy as np

    from icl_tpu_torch.models.layers import DropPath

    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    start = {k: v.clone() for k, v in model.state_dict().items()}
    labeled = step_kw["labeled"]
    n = len(batch["image"])
    reversed_rows = np.concatenate([np.arange(labeled)[::-1], np.arange(labeled, n)[::-1]])

    def run(fuse: bool, scale: float = 1.0, rows=None):
        model.load_state_dict(start)
        model.fuse_sspa_pair = fuse
        wa.reset_launch_counts()
        b = batch if rows is None else {k: np.asarray(v)[rows] for k, v in batch.items()}
        metrics, after = unet_step(torch, model, b, patch, DEVICE, scale, **step_kw)
        launches = launches_now(wa)
        return (metrics, {n: t.clone() for n, t in after.items()}), launches

    t0 = time.perf_counter()
    (reference, ref_launches), (test, launches), (control, _) = run(False), run(True), run(True, 1.0 + 1e-7)
    witness = run(False, 1.0 - 1e-7)[0]
    for k, t in run(False, rows=reversed_rows)[0][1].items():
        if (t - reference[1][k]).abs().max() > (witness[1][k] - reference[1][k]).abs().max():
            witness[1][k] = t
    torch.cuda.synchronize()
    if launches != ref_launches:
        fail(f"{tag} the fused step launched {launches}, the two-call step {ref_launches}")
    before = {n: start[n] for n in reference[1]}
    step_agreement(torch, tag, f"one f32 step, fused sspa pair vs two calls ({time.perf_counter() - t0:.1f} s "
                   f"for the five; window-attention launches of each {launches})", before,
                   {"test": test, "reference": reference, "control": control, "witness": witness})
    del start, reference, test, control, witness, before
    gc.collect()
    torch.cuda.empty_cache()


def phase_bf16_remat(torch, wa, sg, cases) -> dict:
    """56: the bf16 train state with recompute: one SwinUNETR-ICL step
    (phase 9's configuration, f32 forward on the upcast copies) with remat
    against the same step without, from one state, under cuDNN's
    deterministic algorithms: every tensor bit for bit; the SR kernel's
    launches (one a leaf) and the attention launches (the recompute's 16
    more forward) counted; then 2 replays of the captured step
    (`--scan_steps`) against 2 eager steps with remat, bit for bit."""
    import copy
    import dataclasses
    import gc

    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(train_config("float32", 2, 0, "bf16_remat"), state_dtype="bfloat16",
                              scan_steps=2)
    trainer = Trainer(cfg, device=DEVICE)
    remat_modules = [m for m in trainer.model.modules() if isinstance(getattr(m, "remat", None), bool)]
    leaves = sum(1 for _ in trainer.model.parameters())
    batches = brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size, seed=57)
    dev = [trainer.to_device(next(batches)) for _ in range(2)]
    s0 = copy.deepcopy(trainer.train_state())
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        def eager(remat: bool, n: int):
            trainer.load_train_state(s0)
            for m in remat_modules:
                m.remat = remat
            wa.reset_launch_counts()
            sg.reset_launch_counts()
            vecs = [trainer._stacked_step(x) for x in dev[:n]]
            torch.cuda.synchronize()
            launches = {**launches_now(wa), "sgd_bf16": sg.sgd_bf16_update.launches}
            return ({k: v.clone() for k, v in flat(trainer.train_state()).items()},
                    torch.stack(vecs).cpu(), launches)

        t0 = time.perf_counter()
        with_remat, without = eager(True, 1), eager(False, 1)
        step_s = time.perf_counter() - t0
        differ = sorted(k for k in with_remat[0] if not torch.equal(with_remat[0][k], without[0][k]))
        out["one_step"] = {"differ": len(differ), "tensors": len(with_remat[0]),
                           "metrics_equal": torch.equal(with_remat[1], without[1]),
                           "launches": {"remat": with_remat[2], "no_remat": without[2]}}
        print(f"[bf16-remat] one bf16-state step with remat vs without, from one state (cuDNN "
              f"deterministic; {step_s:.1f} s for the two): {len(differ)} of {len(with_remat[0])} "
              f"tensors differ {differ[:8]}, metrics equal {out['one_step']['metrics_equal']}; "
              f"launches {json.dumps(out['one_step']['launches'])}", flush=True)
        want = {"remat": {"fwd": FWD_PER_STEP, "bwd": BWD_PER_STEP},
                "no_remat": {"fwd": BWD_PER_STEP, "bwd": BWD_PER_STEP}}
        for kind, run in (("remat", with_remat), ("no_remat", without)):
            counts = run[2]
            if counts["sgd_bf16"] != leaves or any(
                    counts[d] != {**want[kind][d], "mask": 0} for d in ("fwd", "bwd")):
                fail(f"[bf16-remat] {kind} launches {counts}, expected {want[kind]} and {leaves} SR")
        if differ or not out["one_step"]["metrics_equal"]:
            fail("[bf16-remat] the step with remat differs from the step without")
        for m in remat_modules:
            m.remat = True
        a = eager(True, 2)
        trainer.load_train_state(s0)
        trainer.graph_step(dev[0])  # the eager first step on a side stream, then the capture
        trainer.load_train_state(s0)
        replayed = [trainer.graph_step(x) for x in dev]
        torch.cuda.synchronize()
        b = {k: v.clone() for k, v in flat(trainer.train_state()).items()}
        differ = sorted(k for k in a[0] if not torch.equal(a[0][k], b[k]))
        out["replay"] = {"differ": len(differ), "metrics_equal": torch.equal(a[1], torch.stack(replayed).cpu()),
                         "graph_launches": dict(trainer.graph_launches)}
        print(f"[bf16-remat] 2 replays of the captured bf16-state step with remat vs 2 eager steps from "
              f"one state: {len(differ)} of {len(b)} tensors differ {differ[:8]}, metrics equal "
              f"{out['replay']['metrics_equal']}; launches recorded in the graph "
              f"{out['replay']['graph_launches']}", flush=True)
        if differ or not out["replay"]["metrics_equal"]:
            fail("[bf16-remat] the replayed steps differ from the eager steps")
    finally:
        torch.backends.cudnn.deterministic = False
    del trainer, s0, dev
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phases 57-58: head dims 33-64, run at the kernels' tile of 64 (one
# forward buffer of K and V where two do not fit, N = 343; the backward's
# dQ and dK/dV kernels, fed the forward's output and row log-sum-exp):
# SwinUNETR fs192 (head dim 64 at every
# stage, heads 3-6-12-24) and the Swin-UNet 2D stage 1 at embed 192 (3
# heads of 64); then other head dims of the tile at the 3D stage-1 shapes:
# fs99 (33: not a multiple of 4, the value-by-value loads and stores), fs120
# (40, also timed), fs144 (48), fs189 (63).
FS192 = 192
HEAD_DIM_FS192 = FS192 // 3
# (33 and 48 left this sweep for the time of phases 59-60: the card tests
# hold them at every N and mode)
TILE64_SWEEP_HEAD_DIMS = (40, 63)
TIMED_TILE64_SWEEP_HEAD_DIMS = (40,)
STAGES_2D_D64 = [STAGES_2D[0], REF_STAGE_2D]


def phase_kernels_tile64(torch, F, wa) -> dict:
    """57: both kernels at fs192's 3D shapes and the 2D stage-1 shapes at
    head dim 64, every mode, f32 and bf16, held, repeated and timed; head
    dims 40 and 63 at the 3D stage-1 shapes, 40 timed."""
    fwd = phase_kernel_3d(torch, F, wa, head_dim=HEAD_DIM_FS192, tag="[kernel-fs192]", timed_bf16=True)
    bwd = phase_backward_kernel(torch, F, wa, head_dim=HEAD_DIM_FS192, tag="[bwd-fs192]")
    gen = torch.Generator(device=DEVICE).manual_seed(57)
    fwd2d, bwd2d = [], []
    for stage in STAGES_2D_D64:
        for mode in stage[4]:
            for kind in ((None,) if mode == "none" else ("shift", "random")):
                for dtype in (torch.float32, torch.bfloat16):
                    row, brow = check_2d(torch, F, wa, stage, mode, kind, dtype, gen, tag="2d-d64",
                                         head_dim=HEAD_DIM_FS192, timed=kind != "random")
                    fwd2d.append(row)
                    bwd2d.append(brow)
    sweep = {"fwd": [], "bwd": []}
    for d in TILE64_SWEEP_HEAD_DIMS:
        timed = d in TIMED_TILE64_SWEEP_HEAD_DIMS
        sweep["fwd"] += phase_kernel_3d(torch, F, wa, head_dim=d, stages=STAGES[:1], timed=timed,
                                        tag=f"[kernel-d{d}]", timed_bf16=True)
        sweep["bwd"] += phase_backward_kernel(torch, F, wa, head_dim=d, stages=STAGES[:1], timed=timed,
                                              tag=f"[bwd-d{d}]")
    held = fwd + bwd + fwd2d + bwd2d + sweep["fwd"] + sweep["bwd"]
    largest = {d: max(r["max_abs_err"] for r in held if r["shape"][3] == d)
               for d in (HEAD_DIM_FS192,) + TILE64_SWEEP_HEAD_DIMS}
    print(f"[tile64] fs192's 3D shapes and the 2D stage-1 shapes at head dim 64, and head dims "
          f"{list(TILE64_SWEEP_HEAD_DIMS)} at the 3D stage-1 shapes, held (forward and backward, every "
          f"mode, f32 and bf16, bitwise repeatable): the largest abs error at each {json.dumps(largest)}",
          flush=True)
    return {"fwd": fwd, "bwd": bwd, "fwd2d": fwd2d, "bwd2d": bwd2d, "sweep": sweep}


def phase_fs192_cli(torch, wa, cases, held_out) -> dict:
    """58: SwinUNETR-ICL at --feature_size 192 through its CLI, as phase 55,
    with the seconds its Trainer takes to build the weights."""
    return feature_size_cli(torch, wa, cases, held_out, FS192)


# Head dims above 64 (the tile-64 kernels in 64-column chunks): SwinUNETR
# fs240 (head dim 80, two chunks, the next feature size that divides by 48
# after 192) and fs384 (128, two whole chunks), and a Swin-UNet at 128 a
# head at the 2D stage-1 shapes
FS240, FS384 = 240, 384
HEAD_DIM_2D_WIDE = 128
# the bf16 forward above two chunks: 3, 5 and 10 (the largest it takes),
# each pair of output chunks a CTA of its own
WIDE_ABOVE_TWO_HEAD_DIMS = (192, 320, 640)
# fs240's training stages: each backbone pass at batch LABELED_BS, and the
# forward's launches a step by stage (the pass and its recompute, 2 passes)
TRAIN_STAGES = [(st[0], LABELED_BS) + tuple(st[2:]) for st in STAGES]
FWD_PER_STEP_BY_STAGE = {m: {st: 2 * n for st, n in BWD_PER_STEP_BY_STAGE[m].items()} for m in ("none", "region")}


def wide_forward_above_two(torch, wa) -> list[dict]:
    """59: the bf16 forward above two chunks (head dims 192, 320 and 640) at
    N = 343 (fs48's stage 3 at batch 1: 8 shifted windows, 12 heads; no mask
    and region ids) and N = 49 (the 224^2 / window-7 stage 1 at batch 2;
    no mask and the shift mask), against the plain version with its
    log-sum-exp, the output with and without the store equal and bitwise
    repeatable; a `[wide-c>2]` line a case."""
    gen = torch.Generator(device=DEVICE).manual_seed(592)
    rows = []
    for D in WIDE_ABOVE_TWO_HEAD_DIMS:
        cases = [("stage3", mode, None) for mode in ("none", "region")]
        cases += [(REF_STAGE_2D[0], "none" if kind is None else "mask", kind) for kind in (None, "shift")]
        for name, mode, kind in cases:
            ids = mask = None
            if name == "stage3":
                q, k, v, bias, ids = stage_inputs(torch, (name, 1) + tuple(STAGES[2][2:]), torch.bfloat16, gen, D)
                ids = ids if mode == "region" else None
            else:
                q, k, v, bias, mask = inputs_2d(torch, REF_STAGE_2D, torch.bfloat16, gen, kind, batch=2, head_dim=D)
            scale = D ** -0.5
            out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
            again, lse2 = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
            alone = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)
            torch.cuda.synchronize()
            want, want_lse = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
            err = (out.float() - want.float()).abs()
            lse_err = float((lse - want_lse).abs().max())
            row = {"stage": name, "mode": mode, "dtype": "bfloat16", "shape": list(q.shape),
                   "chunks": -(-D // 64), "max_abs_err": float(err.max()), "lse_max_abs_err": lse_err,
                   "bitwise_repeat": torch.equal(out, again) and torch.equal(lse, lse2),
                   "lse_store_keeps_output": torch.equal(out, alone)}
            ok = (bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()) and row["bitwise_repeat"]
                  and row["lse_store_keeps_output"] and lse_err <= F32_ATOL * max(1.0, float(want_lse.abs().max())))
            print(f"[wide-c>2] {json.dumps(row)}", flush=True)
            if not ok:
                fail(f"the forward above two chunks disagrees with plain or is not repeatable: {row}")
            rows.append(row)
            del q, k, v, bias, out, again, alone, want, err
    torch.cuda.empty_cache()
    return rows


def phase_kernels_wide(torch, F, wa) -> dict:
    """59: both kernels at fs240's 3D shapes (head dim 80 at every stage:
    the inference forward at sw_batch 4 and the training pass, the forward
    at both, NONE and REGION), at fs384's stage 1 (head dim 128; its other
    stages run the same instances as fs240's) and at the 2D stage-1 shapes
    at 3 heads of 128 (NONE, MASK with the shift mask and a random mask),
    f32 and bf16, held and bitwise repeatable (the forward's log-sum-exp
    too); timed beside the bound, the plain version and SDPA (f32; the 3D
    forward in bf16 too); then the bf16 forward above two chunks, held
    (`wide_forward_above_two`)."""
    out = {}
    for fs, stages in ((FS240, STAGES), (FS384, STAGES[:1])):
        out[f"fwd_fs{fs}"] = phase_kernel_3d(torch, F, wa, head_dim=fs // 3, stages=stages, tag=f"[kernel-fs{fs}]",
                                             timed_bf16=True)
        out[f"bwd_fs{fs}"] = phase_backward_kernel(torch, F, wa, head_dim=fs // 3, stages=stages,
                                                   tag=f"[bwd-fs{fs}]")
    out["fwd_fs240_step"] = phase_kernel_3d(torch, F, wa, head_dim=FS240 // 3, stages=TRAIN_STAGES,
                                            tag="[kernel-fs240-step]", timed_bf16=True)
    gen = torch.Generator(device=DEVICE).manual_seed(59)
    out["fwd2d"], out["bwd2d"] = [], []
    for stage in STAGES_2D_D64:
        for mode in stage[4]:
            for kind in ((None,) if mode == "none" else ("shift", "random")):
                for dtype in (torch.float32, torch.bfloat16):
                    row, brow = check_2d(torch, F, wa, stage, mode, kind, dtype, gen, tag="2d-d128",
                                         head_dim=HEAD_DIM_2D_WIDE, timed=kind != "random")
                    out["fwd2d"].append(row)
                    out["bwd2d"].append(brow)
    out["fwd_above_two"] = wide_forward_above_two(torch, wa)
    held = [r for rows in out.values() for r in rows]
    largest = {d: max(r["max_abs_err"] for r in held if r["shape"][3] == d)
               for d in (FS240 // 3, FS384 // 3)}
    print(f"[wide] fs240's and fs384's 3D shapes (head dims 80 and 128, two 64-column chunks) and the 2D "
          f"stage-1 shapes at head dim 128, held (forward and backward, every mode, f32 and bf16, "
          f"bitwise repeatable): the largest abs error at each {json.dumps(largest)}", flush=True)
    return out


def phase_fs240_cli(torch, wa, cases, held_out) -> dict:
    """60: SwinUNETR-ICL at --feature_size 240 (head dim 80 at every stage)
    through its CLI at the CLI's default precision (bf16 autocast, recompute
    on), as phase 58, with the launches of a step asserted and
    test_3D_BraTS reproducing the validation dice."""
    return feature_size_cli(torch, wa, cases, held_out, FS240, precision=None)


def phases_59_60(torch, F, wa, cases, held_out) -> dict:
    """59-60 on phase 9's cases."""
    t0 = time.perf_counter()
    kernels = phase_kernels_wide(torch, F, wa)
    fs240 = phase_fs240_cli(torch, wa, cases, held_out)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    keys = ("s_per_step", "peak_bytes", "build_s", "n_params", "val_dice")
    print(f"[summary] phases 59-60 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({'fs240': {k: fs240[k] for k in keys}})}", flush=True)
    return {"kernels": kernels, "fs240": fs240}


def phases_57_58(torch, F, wa, cases, held_out) -> dict:
    """57-58 on phase 9's cases."""
    t0 = time.perf_counter()
    kernels = phase_kernels_tile64(torch, F, wa)
    fs192 = phase_fs192_cli(torch, wa, cases, held_out)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    keys = ("s_per_step", "peak_bytes", "build_s", "n_params", "val_dice")
    print(f"[summary] phases 57-58 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({'fs192': {k: fs192[k] for k in keys}})}", flush=True)
    return {"kernels": kernels, "fs192": fs192}


# Every head dim (the streamed kernels, ops/csrc/window_attention_stream.cu
# and window_attention_bwd_stream.cu, where the chunked kernels' tiles do not
# fit a CTA): SwinUNETR fs432 (head dim 144, three 64-column chunks) at its
# stage 1, the next feature size that divides by 48 after fs384; a
# Swin-UNet at 192 a head (EMBED_DIM 192, NUM_HEADS 1-2-4-8) at its 2D
# stage 1 and through its CLIs; head dims with ragged and whole last chunks
FS432 = 432
HEAD_DIM_2D_STREAM = 192
STREAM_SWEEP_HEAD_DIMS = (129, 255, 256, 320, 648)
# the 2D path at 192 a head: phase 14's configuration with the yaml's
# EMBED_DIM and NUM_HEADS (head dim 192 at every stage; ~0.33 s/step)
EMBED_2D_STREAM, HEADS_2D_STREAM = 192, (1, 2, 4, 8)
# SwinUNETR fs48 with one head a stage: head dims 48, 96, 192 and 384, the
# tile-64, chunked and streamed kernels in one model; launches by route of
# one inference forward (stage 1 tile, stage 2 wide, stage 3 and stage 4's
# two stream; region ids in stages 1-3)
ONE_HEAD_ROUTES = {"tile": 2, "wide": 2, "stream": 4}
ONE_HEAD_STREAM_MODES = {"none": 3, "region": 1, "mask": 0}


@contextlib.contextmanager
def streamed_route(wa):
    """Every window-attention call in the block on the streamed kernels,
    whatever route the rule would take (it still refuses head dim 0)."""
    rule = wa._route
    wa._route = lambda *a, **kw: rule(*a, **kw) and "stream"
    try:
        yield
    finally:
        wa._route = rule


def stream_case(torch, F, wa, q, k, v, bias, ids, mask, row: dict, timed: bool = False) -> tuple[dict, dict]:
    """The streamed kernels (`streamed_route`, whatever the rule would
    take) on one shape: the forward with its log-sum-exp and the backward
    fed them, each against its plain version (the output and the
    log-sum-exp; both plain backwards) and bitwise repeatable, every launch
    on the streamed route; with `timed` (f32) each direction's time beside
    the bound, the plain version and SDPA. Returns the forward's and the
    backward's rows."""
    with streamed_route(wa):
        return streamed_case(torch, F, wa, q, k, v, bias, ids, mask, row, timed)


def streamed_case(torch, F, wa, q, k, v, bias, ids, mask, row: dict, timed: bool) -> tuple[dict, dict]:
    B, H, N, D = q.shape
    scale = D ** -0.5
    f32 = q.dtype == torch.float32
    wa.reset_launch_counts()
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    again, lse2 = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    err = (out.float() - want.float()).abs()
    lse_err = float((lse - want_lse).abs().max())
    frow = {**row, "dtype": str(q.dtype).split(".")[-1], "shape": list(q.shape), "route": "stream",
            "max_abs_err": float(err.max()), "lse_max_abs_err": lse_err,
            "bitwise_repeat": torch.equal(out, again) and torch.equal(lse, lse2)}
    ok = float(err.max()) <= F32_ATOL if f32 else bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    if (not ok or not frow["bitwise_repeat"] or not torch.isfinite(out).all()
            or lse_err > F32_ATOL * max(1.0, float(want_lse.abs().max()))):
        fail(f"the streamed forward disagrees with plain or is not repeatable: {frow}")
    del again, want, err
    g = torch.randn(q.shape, device=DEVICE, generator=torch.Generator(device=DEVICE).manual_seed(D)).to(q.dtype)
    saved = {"out": out, "lse": lse}
    got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask, **saved)
    rep = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask, **saved)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "dbias")
    tols = {n: BWD_F32_RTOL if f32 or n == "dbias" else BWD_BF16_RTOL for n in names}
    want = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask)
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    brow = {k: frow[k] for k in frow if k not in ("max_abs_err", "lse_max_abs_err", "bitwise_repeat")}
    brow.update(rel_err=errs, tolerance=tols,
                max_abs_err=max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)),
                rel_err_lse_plain=lse_plain_errors(wa, q, k, v, bias, ids, mask, g, scale, saved, got),
                bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, rep)))
    del want, rep
    routes = (dict(wa.window_attention.launches_by_route), dict(wa.window_attention_bwd.launches_by_route))
    if routes != ({"tile": 0, "wide": 0, "stream": 2}, {"tile": 0, "wide": 0, "stream": 2}):
        fail(f"the streamed kernels' launches went elsewhere: {routes}")
    if (not brow["bitwise_repeat"] or not all(bool(torch.isfinite(a).all()) for a in got)
            or any(e > tols[n] for part in (errs, brow["rel_err_lse_plain"]) for n, e in part.items())):
        fail(f"the streamed backward disagrees with plain or is not repeatable: {brow}")
    if timed:
        nW = ids.shape[0] if ids is not None else mask.shape[0] if mask is not None else B
        dense = wa.mask_from_region_ids(ids) if ids is not None else mask
        shape = (B // nW, nW, H, N, D) if dense is not None else (B, H, N, D)
        qs, ks, vs = (t.view(shape) for t in (q, k, v))
        attn = (bias if dense is None else bias[None] + dense[:, None]).to(q.dtype)
        mask_floats = ids.numel() if ids is not None else mask.numel() if mask is not None else 0
        frow.update(ms=cuda_ms(lambda: wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)),
                    plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale)),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn,
                                                                              scale=scale)),
                    **bound_fields(*bound(B, H, N, D, mask_floats)))
        brow.update(ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask,
                                                               **saved), reps=5, warmup=1),
                    plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale,
                                                                           mask=mask), reps=3),
                    library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, dense, g, scale),
                    **bound_fields(*bound(B, H, N, D, mask_floats, backward=True)))
        del attn
    print(f"[stream] {json.dumps(frow)}", flush=True)
    print(f"[stream-bwd] {json.dumps(brow)}", flush=True)
    del q, k, v, g, out, lse, got, saved
    torch.cuda.empty_cache()
    return frow, brow


def one_head_path(torch, wa) -> dict:
    """61: SwinUNETR fs48 with one head a stage (head dims 48, 96, 192 and
    384) on phase 5's volume: one sliding-window inference forward's
    launches by route and the streamed ones by mode (asserted:
    `ONE_HEAD_ROUTES` and `ONE_HEAD_STREAM_MODES` a forward), its
    probabilities against the plain
    attention, then one f32 supervised pass's backward (cross-entropy on
    a seeded label map, drop path off) through the same kernels: its
    launches by route, by mode and the streamed ones by mode (asserted:
    `ONE_HEAD_ROUTES`, 5 no-mask + 3 region and `ONE_HEAD_STREAM_MODES`),
    the loss and the gradients of the streamed
    stages' attention parameters against the plain attention's, by
    phase 10's rule (loss 1e-4 relative; each gradient within
    STEP_UPDATE_RTOL of its largest magnitude), beside a control: the
    kernels' pass on the input times 1 + 1e-7, which shows how far f32
    rounding of the forward alone moves those gradients."""
    import numpy as np

    from icl_tpu_torch.eval.infer3d import make_patch_predictor, sliding_window_predict
    from icl_tpu_torch.models.layers import DropPath, build_model
    from icl_tpu_torch.models.swinunetr import SwinUNETR, WindowAttention3D

    model = build_model(SwinUNETR, 1, 2, feature_size=FEATURE_SIZE, num_heads=(1, 1, 1, 1),
                        device=DEVICE, generator=torch.Generator().manual_seed(61)).eval()
    probs_fn = make_patch_predictor(model)
    volume = np.random.default_rng(61).standard_normal(VOLUME).astype(np.float32)
    wa.reset_launch_counts()
    labels = sliding_window_predict(probs_fn, volume, 2, (PATCH,) * 3, STRIDE, STRIDE, SW_BATCH, device=DEVICE)
    torch.cuda.synchronize()
    routes = dict(wa.window_attention.launches_by_route)
    fwd_stream = dict(wa.window_attention.launches_by_route_mode["stream"])
    n_forwards = wa.window_attention.launches // sum(ONE_HEAD_ROUTES.values())
    if routes != {r: n_forwards * n for r, n in ONE_HEAD_ROUTES.items()} or n_forwards < 1 \
            or fwd_stream != {m: n_forwards * n for m, n in ONE_HEAD_STREAM_MODES.items()} \
            or labels.shape != volume.shape:
        fail(f"[one-head] launches by route {routes}, streamed by mode {fwd_stream}, over "
             f"{wa.window_attention.launches} launches, expected {ONE_HEAD_ROUTES} and {ONE_HEAD_STREAM_MODES} "
             "a forward")
    x = torch.from_numpy(volume[None, None, :PATCH, :PATCH, :PATCH]).to(DEVICE).repeat(2, 1, 1, 1, 1)
    x[1] = x[1].flip(-1)
    y = torch.from_numpy(np.random.default_rng(62).integers(0, 2, (2,) + (PATCH,) * 3)).to(DEVICE)
    attns = [m for m in model.modules() if isinstance(m, WindowAttention3D)]
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    streamed = [n for n, p in model.named_parameters() if "attn" in n and ("layers3" in n or "layers4" in n)]
    params = dict(model.named_parameters())
    runs = {}
    for name, fn, scale in (("kernel", wa.window_attention, 1.0), ("plain", wa.window_attention_plain, 1.0),
                            ("control", wa.window_attention, 1.0 + 1e-7)):
        for m in attns:
            m.attention = fn
        model.zero_grad(set_to_none=True)
        wa.reset_launch_counts()
        model.train()
        loss = torch.nn.functional.cross_entropy(model(x * scale), y)
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = {"loss": float(loss.detach()), "grads": {n: params[n].grad.detach().clone() for n in streamed},
                      "bwd_routes": dict(wa.window_attention_bwd.launches_by_route),
                      "bwd_modes": dict(wa.window_attention_bwd.launches_by_mode),
                      "bwd_stream": dict(wa.window_attention_bwd.launches_by_route_mode["stream"])}
        with torch.no_grad():
            model.eval()
            runs[name]["probs"] = probs_fn(x)
    for m in attns:
        m.attention = wa.window_attention
    probs_err = float((runs["kernel"]["probs"] - runs["plain"]["probs"]).abs().max())
    grad_err = {n: rel_err(runs["kernel"]["grads"][n], runs["plain"]["grads"][n]) for n in streamed}
    control_err = {n: rel_err(runs["control"]["grads"][n], runs["kernel"]["grads"][n]) for n in streamed}
    loss_err = abs(runs["kernel"]["loss"] - runs["plain"]["loss"]) / abs(runs["plain"]["loss"])
    out = {"launches_by_route": routes, "forwards": n_forwards, "probs_max_abs_err": probs_err,
           "loss_rel_err": loss_err, "grad_rel_err_max": max(grad_err.values()),
           "control_grad_rel_err_max": max(control_err.values()),
           "bwd_launches_by_route": runs["kernel"]["bwd_routes"], "bwd_launches_by_mode": runs["kernel"]["bwd_modes"],
           "fwd_stream_by_mode": fwd_stream, "bwd_stream_by_mode": runs["kernel"]["bwd_stream"]}
    print(f"[one-head] SwinUNETR fs48, heads (1, 1, 1, 1) (head dims 48, 96, 192, 384): {json.dumps(out)}",
          flush=True)
    if probs_err > PROBS_ATOL or loss_err > STEP_LOSS_RTOL or max(grad_err.values()) > STEP_UPDATE_RTOL \
            or runs["kernel"]["bwd_routes"] != ONE_HEAD_ROUTES \
            or runs["kernel"]["bwd_modes"] != {"none": 5, "region": 3, "mask": 0} \
            or runs["kernel"]["bwd_stream"] != ONE_HEAD_STREAM_MODES:
        fail(f"[one-head] the streamed path disagrees with the plain attention or missed a kernel: {out}, "
             f"grads {grad_err}")
    del model, probs_fn, runs, params, x, y
    torch.cuda.empty_cache()
    return out


def phase_kernels_stream(torch, F, wa) -> dict:
    """61: the streamed kernels alone (`stream_shape_rows`), then
    `one_head_path`."""
    return {**stream_shape_rows(torch, F, wa), "one_head": one_head_path(torch, wa)}


def stream_shape_rows(torch, F, wa) -> dict:
    """61: the streamed kernels alone (asked for by route, the rule's route
    asserted where it takes them): SwinUNETR fs432's stage 1 (head dim 144)
    at the inference forward's [1372, 3, 343, 144] and the training pass's
    [686, 3, 343, 144], no mask and region ids; the Swin-UNet 2D stage 1
    at 192 a head [512, 1, 144, 192], no mask, the shift mask and a random
    mask; head dims 129, 255, 256, 320 and 648 at N 343 (region ids), 144
    (the shift mask) and 49 (a random mask); f32 and bf16, forward with its
    log-sum-exp and backward, held and bitwise repeatable (`stream_case`),
    f32 timed at fs432 and the 2D shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(61)
    rows = {"fwd": [], "bwd": []}

    def add(pair):
        rows["fwd"].append(pair[0])
        rows["bwd"].append(pair[1])

    for stage, name in (((STAGES[0][0], SW_BATCH) + tuple(STAGES[0][2:]), "fs432_stage1"),
                        ((STAGES[0][0], LABELED_BS) + tuple(STAGES[0][2:]), "fs432_train_stage1")):
        for mode in ("none", "region"):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias, ids = stage_inputs(torch, stage, dtype, gen, FS432 // 3)
                ids = ids if mode == "region" else None
                if dtype == torch.float32 and wa._route(q.shape[2], q.shape[3]) != "stream":
                    fail(f"the rule does not stream fs432's f32 stage 1: {wa._route(q.shape[2], q.shape[3])}")
                add(stream_case(torch, F, wa, q, k, v, bias, ids, None, {"stage": name, "mode": mode},
                                timed=dtype == torch.float32))
    stage = (STAGES_2D[0][0], STAGES_2D[0][1], STAGES_2D[0][2], 1, STAGES_2D[0][4])
    for kind in (None, "shift", "random"):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias, mask = inputs_2d(torch, stage, dtype, gen, kind, head_dim=HEAD_DIM_2D_STREAM)
            add(stream_case(torch, F, wa, q, k, v, bias, None, mask,
                            {"stage": "2d_d192_stage1", "mode": "none" if kind is None else "mask", "mask": kind},
                            timed=dtype == torch.float32 and kind != "random"))
    for D in STREAM_SWEEP_HEAD_DIMS:
        for N, kind in ((343, "region"), (144, "shift"), (49, "random")):
            for dtype in (torch.float32, torch.bfloat16):
                if N == 343:
                    q, k, v, bias, ids = stage_inputs(torch, ("stage3", 1) + tuple(STAGES[2][2:5]) + (3,),
                                                      dtype, gen, D)
                    mask = None
                else:
                    side, ws = (24, 12) if N == 144 else (14, 7)
                    q, k, v, bias, mask = inputs_2d(torch, ("sweep", side, ws, 3, {}), dtype, gen, kind, batch=2,
                                                    head_dim=D)
                    ids = None
                add(stream_case(torch, F, wa, q, k, v, bias, ids, mask,
                                {"stage": f"d{D}_n{N}", "mode": "region" if ids is not None else "mask",
                                 "mask": kind}))
    largest = {d: max(r["max_abs_err"] for r in rows["fwd"] + rows["bwd"] if r["shape"][3] == d and
                      r["dtype"] == "float32") for d in (FS432 // 3, HEAD_DIM_2D_STREAM) + STREAM_SWEEP_HEAD_DIMS}
    print(f"[stream] the streamed kernels at fs432's stage 1, the 2D stage 1 at head dim 192 and head dims "
          f"{list(STREAM_SWEEP_HEAD_DIMS)}, held (forward with its log-sum-exp and backward, every mode, f32 and "
          f"bf16, bitwise repeatable): the largest f32 abs error at each {json.dumps(largest)}", flush=True)
    return rows


def stream_2d_cfg_file() -> str:
    """The repo's Swin yaml with EMBED_DIM 192, NUM_HEADS 1-2-4-8 and
    WINDOW_SIZE 12, written under SUP_ROOT; its path."""
    import yaml

    with open(os.path.join(ROOT, "configs", "swin_tiny_patch4_window7_224_lite.yaml")) as f:
        spec = yaml.safe_load(f)
    spec["MODEL"]["SWIN"].update(EMBED_DIM=EMBED_2D_STREAM, NUM_HEADS=list(HEADS_2D_STREAM), WINDOW_SIZE=WINDOW_2D)
    spec["DATA"]["IMG_SIZE"] = IMG_2D
    os.makedirs(SUP_ROOT, exist_ok=True)
    path = os.path.join(SUP_ROOT, "swin_d192_window12_384.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    return path


def phase_swinunet_d192_cli(torch, wa, slices, volumes) -> dict:
    """62: Swin-UNet-ICL 2D at head dim 192 through its CLI's `main`:
    phase 14's configuration (384^2, window 12, batch 16 of which 8
    labeled, f32 with TF32 off) with a `--cfg` yaml of EMBED_DIM 192 and
    NUM_HEADS 1-2-4-8, on phase 14's slices and volumes in memory: 3 steps
    and a validation, the launches per step asserted as phase 14's (28
    forward and 28 backward, 16 no-mask + 12 mask) and every launch of the
    run on the streamed route; s/step, peak memory, the seconds to build
    the model and its parameters; one step through the kernels against the
    plain attention by phase 15's rule; test_2D_ACDC --model icl_swinunet
    --cfg on the best checkpoint gives the validation dice."""
    from icl_tpu_torch.models.swin2d import SwinConfig, WindowAttention
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_inherent_consistent_swinunet_2D as cli
    from icl_tpu_torch.train import trainer as trainer_module
    from icl_tpu_torch.train.steps import METRIC_KEYS

    cfg_path = stream_2d_cfg_file()
    data = InMemoryDataset(slices, volumes)
    common = ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/SwinICL_d192", "--num_tries", "d192",
              "--patch_size", str(IMG_2D), str(IMG_2D), "--cfg", cfg_path]
    built = {}
    factory = trainer_module.net_factory

    def timed_factory(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = factory(*args, **kwargs)
        torch.cuda.synchronize()
        built.setdefault("build_s", time.perf_counter() - t0)
        built.setdefault("n_params", sum(p.numel() for p in model.parameters()))
        return model

    saved = cli.patients_to_slices
    cli.patients_to_slices = lambda root, num: LABELED_SLICES_2D
    trainer_module.net_factory = timed_factory
    torch.manual_seed(0)  # drop-path masks
    try:
        run = run_cli(torch, wa, cli, common + ["--max_iterations", str(TRAIN_STEPS), "--val_interval",
                                                str(TRAIN_STEPS)], "ACDCDataset", data, "[d192]", METRIC_KEYS,
                      TRAIN_STEPS, {"fwd": PER_STEP_2D, "bwd": PER_STEP_2D})
    finally:
        cli.patients_to_slices = saved
        trainer_module.net_factory = factory
    run.update(built)
    routes = {"fwd": dict(wa.window_attention.launches_by_route),
              "bwd": dict(wa.window_attention_bwd.launches_by_route)}
    totals = {kind: sum(run["run_launches"][kind].values()) for kind in ("fwd", "bwd")}
    print(f"[d192] Swin-UNet-ICL embed {EMBED_2D_STREAM}, heads {list(HEADS_2D_STREAM)} (head dim "
          f"{HEAD_DIM_2D_STREAM}): {built['n_params']} parameters, the Trainer's model built in "
          f"{built['build_s']:.2f} s; {run['s_per_step']:.4f} s/step, peak memory "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; launches of the run by route {routes}", flush=True)
    steps_by_route = run["path_launches_by_route_mode"]
    if routes != {kind: {"tile": 0, "wide": 0, "stream": totals[kind]} for kind in ("fwd", "bwd")} or any(
            steps_by_route[kind]["stream"] != run["path_launches"][kind] for kind in ("fwd", "bwd")):
        fail(f"[d192] launches off the streamed route: {routes}, the steps' {steps_by_route}")
    run["path_launches_by_route"] = routes
    step_cfg = train_config_2d(1, 0, "step-d192")
    step_cfg.model_kwargs = {"swin_cfg": SwinConfig(img_size=IMG_2D, window_size=WINDOW_2D,
                                                    embed_dim=EMBED_2D_STREAM, num_heads=HEADS_2D_STREAM)}
    blocks = [f"layers.{i}.blocks.{b}" for i in (0, 3) for b in (0, 1)] + ["layers_up.3.blocks.1"]
    watched = [f"swin_unet.{blk}.attn.{t}" for blk in blocks
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]
    per_step = sum(PER_STEP_2D.values())
    step_parity(torch, wa, step_cfg, next(acdc_batches(slices, step_cfg)), watched, WindowAttention,
                (per_step, per_step), "[step-d192]")
    eval_dice = eval_cli(test_2D_ACDC, common + ["--model", "icl_swinunet"], "ACDCDataset", data)
    print(f"[eval-d192] test_2D_ACDC --model icl_swinunet --cfg (embed {EMBED_2D_STREAM}) on the best "
          f"checkpoint: mean dice {eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail("test_2D_ACDC does not reproduce the head-dim-192 Swin-UNet-ICL's validation dice")
    return run


def phases_61_62(torch, F, wa, slices, volumes) -> dict:
    """61-62 on phase 14's slices and volumes."""
    t0 = time.perf_counter()
    kernels = phase_kernels_stream(torch, F, wa)
    d192 = phase_swinunet_d192_cli(torch, wa, slices, volumes)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    keys = ("s_per_step", "peak_bytes", "build_s", "n_params", "val_dice")
    print(f"[summary] phases 61-62 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({'d192': {k: d192[k] for k in keys}, 'one_head': kernels['one_head']})}", flush=True)
    return {"kernels": kernels, "d192": d192}


def main(argv: list) -> int:
    """Every phase. `--from 41` runs phases 1-2, 41-43 and 47-52 only (the
    multi-process ones, phase 42's ranks running phase 48), `--from 54`
    phases 1-2 and 54-60, `--from 61` phases 1-2 and 61-62, and none of
    them prints a result: a partial run, to iterate on them."""
    start = int(argv[argv.index("--from") + 1]) if "--from" in argv else 1
    if start not in (1, 41, 54, 61):
        print("chip_smoke: --from takes 41, 54 or 61", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    marks = [t_script]

    def stamp(phases: str) -> None:
        now = time.perf_counter()
        print(f"[time] phases {phases}: {now - marks[-1]:.1f} s", flush=True)
        marks.append(now)

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with final_state_not_written(name) if name in UNWRITTEN_FINAL_STATES else contextlib.nullcontext():
                    return fn(*args, **kwargs)
            finally:
                print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return run

    for name, fn in list(globals().items()):  # each phase's seconds
        if name.startswith(("phase_", "tp_prepare", "run_card_tests")) and callable(fn):
            globals()[name] = timed(name, fn)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F

    from icl_tpu_torch.eval.infer3d import _grid_starts, make_patch_predictor, sliding_window_predict
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.models.swinunetr import WindowAttention3D
    from icl_tpu_torch.ops import sgd_bf16 as sg
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.ops.build import build_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record_fits()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    kind = torch.cuda.get_device_name(0)
    print(f"[card] nvidia-smi: {card} | torch: {kind} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. the builds, one nvcc per source, started together
    t0 = time.perf_counter()
    sources = ("window_attention", "window_attention_bwd", "window_attention_wide", "window_attention_bwd_wide",
               "window_attention_stream", "window_attention_bwd_stream", "sgd_bf16")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host_build = pool.submit(build_host_helper)
        builds = list(pool.map(build_library, sources))
        host_build = host_build.result()
    build_s = time.perf_counter() - t0
    print(f"[build] the host's C++ helper {json.dumps(host_build)}", flush=True)
    for source, (lib_path, log) in zip(sources, builds[:6]):
        usage = ptxas_usage(log, source) if log else "already built"
        spills = sorted(n for n, (_, spill) in usage.items() if spill) if log else "not read"
        print(f"[build] {lib_path}: registers and spill stores (bytes) per instance {json.dumps(usage)}; "
              f"instances that spill: {spills or 'none'}", flush=True)
    sgd_log = [line.strip() for line in builds[6][1].splitlines() if "Used" in line or "spill" in line]
    print(f"[build] {builds[6][0]}: {sgd_log or 'already built'}", flush=True)
    print(f"[build] the seven libraries in {build_s:.2f} s", flush=True)
    for what, query, too_large in (("window_attention", wa._fwd_geometry, 1000),
                                   ("window_attention_bwd", wa._bwd_geometry, 450)):
        geometry = {f"N{n} D{d}": dict(zip(("warps", "smem_bytes", "ctas_per_sm"),
                                           query(n, d, False, True, False, 0)))
                    for n, d in ((343, 16), (216, 16), (144, 32), (49, 32), (4, 32), (343, 64), (144, 64),
                                 (49, 64), (343, 80), (144, 128), (49, 128))}
        print(f"[build] {what} f32 MASK geometry per CTA: {json.dumps(geometry)}", flush=True)
        # the rule's mirror of the backward's tiles 16 and 32, which sends larger windows to the streamed kernels
        if what == "window_attention_bwd" and any(
                geometry[f"N{n} D{d}"]["smem_bytes"] != wa._bwd_tile_smem_bytes(n, d)
                for n, d in ((343, 16), (216, 16), (144, 32), (49, 32), (4, 32))):
            fail(f"the tiles 16 and 32 of the backward disagree with _bwd_tile_smem_bytes: {geometry}")
        # the tile-64 kernels' shared memory does not grow with N (the backward's but for the ids);
        # three 64-column chunks of the head dim fit neither in f32
        for n, d in ((too_large, HEAD_DIM_2D), (343, 129)):
            try:
                query(n, d, False, False, False, 0)
                fail(f"{what}'s geometry took a window of {n} tokens at head dim {d}")
            except ValueError as e:
                print(f"[build] refused as it should be: {e}", flush=True)
    # the streamed kernels take those: one geometry at every head dim and window
    for what, query in (("window_attention_stream", wa._stream_fwd_geometry),
                        ("window_attention_bwd_stream", wa._stream_bwd_geometry)):
        geometry = {f"N{n} D{d} {'bf16' if bf16 else 'f32'}": query(n, d, False, True, bf16, 0)
                    for n, d in ((343, 129), (343, 144), (144, 192), (1000, 32), (49, 648)) for bf16 in (False, True)}
        if len(set(geometry.values())) != 1:
            fail(f"{what}'s geometry changes with the head dim, window or type: {geometry}")
        print(f"[build] {what} MASK (warps, smem_bytes, ctas_per_sm) at every head dim, window and type: "
              f"{json.dumps(geometry)}", flush=True)
    z = [torch.zeros(1, 1, 8, HEAD_DIM, device=DEVICE) for _ in range(4)]
    wa.window_attention(*z[:3], torch.zeros(1, 8, 8, device=DEVICE), scale=1.0)
    wa.window_attention_bwd(*z[:3], torch.zeros(1, 8, 8, device=DEVICE), None, z[3], scale=1.0)
    torch.cuda.synchronize()
    if start == 54:
        from icl_tpu_torch.data.synth import synthetic_acdc, synthetic_brats_cases

        shutil.rmtree(EXPERIMENTS, ignore_errors=True)
        cases, held_out = synthetic_brats_cases(4, CASE_SIZE, seed=0), synthetic_brats_cases(1, CASE_SIZE, seed=1)
        phases_54_56(torch, F, wa, sg, cases, held_out)
        stamp("54-56")
        phases_57_58(torch, F, wa, cases, held_out)
        stamp("57-58")
        phases_59_60(torch, F, wa, cases, held_out)
        stamp("59-60")
        print(f"[summary] a partial run from phase 54 passed in {time.perf_counter() - t_script:.1f} s; "
              f"the result lines belong to the whole run", flush=True)
        return 0
    if start == 61:
        from icl_tpu_torch.data.synth import synthetic_acdc

        shutil.rmtree(EXPERIMENTS, ignore_errors=True)
        slices, volumes = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D, CLASSES_2D, seed=0)
        phases_61_62(torch, F, wa, slices, volumes)
        stamp("61-62")
        print(f"[summary] a partial run from phase 61 passed in {time.perf_counter() - t_script:.1f} s; "
              f"the result lines belong to the whole run", flush=True)
        return 0

    if start <= 40:
        # 3 + 4. the forward kernel against its plain version, and times
        per_shape = phase_kernel_3d(torch, F, wa)

        stamp("1-4")
        # 5. the main path
        model = net_factory("swinunetr_icl", 1, 2, device=DEVICE, feature_size=FEATURE_SIZE,
                            generator=torch.Generator().manual_seed(0), inference=True).eval()
        probs_fn = make_patch_predictor(model)
        volume = np.random.default_rng(0).standard_normal(VOLUME).astype(np.float32)
        args = (probs_fn, volume, 2, (PATCH,) * 3, STRIDE, STRIDE, SW_BATCH)
        sliding_window_predict(*args, device=DEVICE)  # warm-up: cuDNN plans, allocator
        wa.reset_launch_counts()
        t0 = time.perf_counter()
        labels = sliding_window_predict(*args, device=DEVICE)
        torch.cuda.synchronize()
        volume_s = time.perf_counter() - t0
        launches = dict(wa.window_attention.launches_by_mode)
        total = wa.window_attention.launches
        print(f"[path] sliding window {VOLUME}, fs{FEATURE_SIZE}, {PATCH}^3 patches, stride {STRIDE}, "
              f"sw_batch {SW_BATCH}: {volume_s:.3f} s/volume; "
              f"launches {total} {launches}; labels {np.bincount(labels.ravel(), minlength=2).tolist()}",
              flush=True)
        if labels.shape != volume.shape or labels.max() > 1:
            fail(f"label map {labels.shape} max {labels.max()}")
        n_forwards = math.ceil(math.prod(len(_grid_starts(d, PATCH, STRIDE)) for d in VOLUME) / SW_BATCH)
        expected = {mode: n_forwards * sum(PER_FORWARD[mode].values()) for mode in ("none", "region")}
        expected["mask"] = 0
        if total != sum(expected.values()) or launches != expected:
            fail(f"expected {sum(expected.values())} launches {expected}, got {total} {launches}")

        # 6. one sw_batch forward against the plain attention, same weights
        x = torch.from_numpy(volume[:PATCH, :PATCH, :PATCH]).to(DEVICE)
        x = torch.stack([x, x.flip(0), x.flip(1), x.flip(2)])[:, None]
        probs = probs_fn(x)
        attns = [m for m in model.modules() if isinstance(m, WindowAttention3D)]
        for m in attns:
            m.attention = wa.window_attention_plain
        probs_plain = probs_fn(x)
        for m in attns:
            m.attention = wa.window_attention
        probs_err = float((probs - probs_plain).abs().max())
        print(f"[path] one sw_batch forward, kernel vs plain attention: probs max abs err {probs_err:.3e} "
              f"(tolerance {PROBS_ATOL})", flush=True)
        if not torch.isfinite(probs).all() or probs_err > PROBS_ATOL:
            fail("forward through the kernel disagrees with the plain attention")

        del model, probs_fn, probs, probs_plain, x
        torch.cuda.empty_cache()

        stamp("5-6")
        # 7 + 8. the backward kernel
        bwd_rows = phase_backward_kernel(torch, F, wa)

        stamp("7-8")
        # 9 - 11. the training path, the step against plain attention, train -> eval
        from icl_tpu_torch.data.synth import synthetic_brats_cases

        shutil.rmtree(EXPERIMENTS, ignore_errors=True)
        cases = synthetic_brats_cases(4, CASE_SIZE, seed=0)
        held_out = synthetic_brats_cases(1, CASE_SIZE, seed=1)
        training = phase_training(torch, wa, cases, held_out)
        phase_step_parity(torch, wa, cases, training.pop("trainer"))
        phase_train_to_eval(torch, held_out, training)

        stamp("9-11")
        # 12 - 16. this slice: the 2D kernels, the Swin-UNet-ICL training path,
        # its step against plain attention, train -> eval
        from icl_tpu_torch.data.synth import synthetic_acdc

        fwd_rows_2d, bwd_rows_2d = phase_kernels_2d(torch, F, wa)
        slices, volumes = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D, CLASSES_2D,
                                         seed=0)
        training_2d = phase_training_2d(torch, wa, slices, volumes)
        phase_step_parity_2d(torch, wa, slices)
        phase_train_to_eval_2d(torch, volumes, training_2d)

        stamp("12-16")
        # 17 - 20. this slice: U-Net-ICL training on the same data, its step on
        # the card against the CPU, the fused sspa pair, train -> eval
        training_unet = phase_training_unet(torch, wa, slices, volumes)
        phase_unet_device_vs_cpu(torch, slices)
        phase_unet_fused_pair(torch, slices)
        phase_train_to_eval_unet(torch, volumes, training_unet)

        stamp("17-20")
        # 21 - 27. this slice: U-Net-ICL 3D on BraTS, its step on the card
        # against the CPU, the supervised U-Net 3D, train -> eval; the AMOS
        # CLIs and train -> eval
        training_unet3d = phase_training_unet3d(torch, wa, cases, held_out)
        phase_unet3d_device_vs_cpu(torch, cases)
        supervised_unet3d = phase_supervised_unet3d(torch, wa, cases)
        phase_train_to_eval_unet3d(torch, held_out, training_unet3d)
        amos_icl, amos_sup = phase_amos(torch, wa)

        stamp("21-27")
        # 28 - 32. this slice: the kernels at the supervised paths' shapes, the
        # three supervised CLIs with train -> eval, and the resume
        sup_rows = phase_kernels_supervised(torch, F, wa)
        sup_unet = phase_supervised_unet_2d(torch, wa, slices, volumes)
        sup_swinunet = phase_supervised_swinunet_2d(torch, wa, slices, volumes)
        sup_swinunetr = phase_supervised_swinunetr_3d(torch, wa, cases, held_out)
        torch.backends.cudnn.deterministic = True
        try:
            resume = phase_resume(torch, slices)
        finally:
            torch.backends.cudnn.deterministic = False
        print(f"[summary] resume: {json.dumps(resume)}", flush=True)

        stamp("28-32")
        # 33 - 35. this slice: FixMatch-CTA through its CLI at the JAX defaults,
        # its step on the card against the CPU, the resume of its saved run
        t0 = time.perf_counter()
        cta = phase_fixmatch_cta(torch, wa, slices, volumes)
        phase_fixmatch_device_vs_cpu(torch, slices)
        cta_resume = phase_fixmatch_resume(torch, wa, slices, volumes, cta)
        shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
        print(f"[summary] FixMatch-CTA phases 33-35 in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps({'s_per_step': {k: cta[k]['s_per_step'] for k in ('lag1', 'lag0')}, 'peak_gib': cta['lag1']['peak_bytes'] / 2**30, 'batch_s': cta['batch_s'], 'step_s': cta['step_s'], 'moved': cta['moved'], 'resume': cta_resume})}",
              flush=True)

        stamp("33-35")
        # 36 - 40. this slice: the flagship's fast configuration: the SR kernel
        # and the card's kernel tests, the fast CLI, graph replay against eager,
        # the dispatch window and the bf16 resume, the device augment
        t0 = time.perf_counter()
        sgd_row = phase_sgd_kernel(torch, sg)

        fast = phase_fast_cli(torch, wa, sg, slices, volumes)
        graph = phase_graph_vs_eager(torch, wa, slices)
        card_run = start_card_tests()  # beside 39 and 40, which time nothing on the card
        dispatch = phase_dispatch_and_resume(torch, slices)
        augment = phase_device_augment(torch, slices)
        card_tests = run_card_tests(card_run)
        shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
        print(f"[summary] fast configuration phases 36-40 in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps({'card_tests': card_tests, 'fast_peak_gib': fast['peak_bytes'] / 2**30, 'fast_state_bytes': fast['state_bytes'], 'graph': {k: graph[k] for k in ('fast', 'swin', 'amos')}, 'upsample_backward_bitwise': graph['upsample_backward_bitwise'], 'dispatch': dispatch, 'augment': augment})}",
              flush=True)

        stamp("36-40")
    else:  # --from 41: phases 41 on need the data of phases 9 and 12
        from icl_tpu_torch.data.synth import synthetic_acdc, synthetic_brats_cases

        slices, volumes = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D,
                                         CLASSES_2D, seed=0)
        held_out = synthetic_brats_cases(1, CASE_SIZE, seed=1)
        training = {"peak_bytes": None}

    # 41 - 43. this slice: the 3D steps repeat bit for bit; the flagship as
    # 2 ranks on the card (its CLI, and 2 ranks against 1 process); NCCL at
    # world size 1 and the sliding window over 2 ranks
    t0 = time.perf_counter()
    repeats = phase_3d_repeats(torch)
    prep = tp_prepare(torch, training["peak_bytes"])
    dp = phase_data_parallel(torch, slices, volumes)
    dp_window = phase_collectives_and_window(torch)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    print(f"[summary] data-parallel phases 41-43 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({'repeats': repeats, 'dp': dp, 'window': dp_window})}", flush=True)

    stamp("41-43")
    if start == 1:
        # 44 - 46. this slice: gradient accumulation on the flagship; FixMatch-CTA
        # with the Swin-UNet through its CLI; the FLOP lines of every fit
        t0 = time.perf_counter()
        accum = phase_grad_accum(torch, wa, slices, volumes)
        cta_swin = phase_fixmatch_cta_swin(torch, wa, slices, volumes)
        flop_lines = phase_flop_lines(torch)
        shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
        print(f"[summary] phases 44-46 in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps({'accum': accum, 'cta_swin': cta_swin, 'flops': flop_lines}, default=str)}",
              flush=True)

    stamp("44-46")
    # 47 - 52. this slice: tensor parallelism over a model axis: the rule
    # table, the flagship over tp=2 (against one process, replicas, the eager
    # repeat, the bf16 state, save and restore both ways), SwinUNETR-ICL fs48
    # over tp=2 (the kernels at the local shapes and their launches by heads,
    # its step against one process, train -> eval), the flagship over dp2 x tp2
    tp = phase_tensor_parallel(torch, wa, sg, held_out, prep, dp["tp"])
    stamp("47-52")
    if start > 1:
        print(f"[summary] a partial run from phase {start} passed in "
              f"{time.perf_counter() - t_script:.1f} s; the result lines belong to the whole run",
              flush=True)
        return 0
    # 53. this slice: the host's C++ helper against scipy, and its calls on
    # the host batches of phases 14, 17 and 33, native against scipy
    helper = phase_native_helper(host_build)
    tp_times = phase_tp_local_times(torch, F, wa)
    on_paths = {"swin_unet_icl_2d": training_2d["host"], "unet_icl_2d": training_unet["host"],
                "fixmatch_cta": cta["host"]}
    print(f"[native] the host helper and the host batches of phases 14, 17 and 33: "
          f"{json.dumps({'helper': helper, 'host_batches': on_paths})}", flush=True)
    print(f"[summary] phase 53: {len(tp_times)} tp=2 local shapes timed, both kernels", flush=True)
    stamp("53")
    # 54 - 56. this slice: SwinUNETR at feature size 24 (the kernels at head
    # dim 8 and its CLI end to end), other head dims, the bf16 state with
    # recompute (the Swin ICL models' fused sspa pair runs in 10 and 15)
    new = phases_54_56(torch, F, wa, sg, cases, held_out)
    stamp("54-56")
    # 57 - 58. this slice: head dims 33-64 (the kernels' tile of 64) at
    # SwinUNETR fs192's and the 2D stage-1 shapes, and SwinUNETR-ICL at
    # feature size 192 through its CLI end to end
    tile64 = phases_57_58(torch, F, wa, cases, held_out)
    stamp("57-58")
    # 59 - 60. this slice: head dims above 64 (the tile-64 kernels in chunks of
    # 64 columns) at SwinUNETR fs240's and fs384's and the 2D stage-1 shapes,
    # and SwinUNETR-ICL at feature size 240 through its CLI end to end
    wide = phases_59_60(torch, F, wa, cases, held_out)
    stamp("59-60")
    # 61 - 62. this slice: every head dim (the streamed kernels) at SwinUNETR
    # fs432's and the 2D stage-1 shapes at head dim 192, a one-head SwinUNETR
    # through every route, and Swin-UNet-ICL 2D at head dim 192 through its CLIs
    stream = phases_61_62(torch, F, wa, slices, volumes)
    stamp("61-62")

    # The kernels line, one entry per kernel and mode. Times are sums over
    # the shapes of a unit of work, each f32 launch time times its launches
    # there: for no-mask and mask one Swin-UNet-ICL training step at 384^2
    # (two passes at batch 8; this slice's path, phases 12-13), for region
    # one SwinUNETR inference forward (forward, phase 4) or training step
    # (backward, phase 8); `paths` holds the other units. `launches`: the
    # training run of the same path (3 steps and a validation, phases 14 or
    # 9), the other paths' runs beside it in `launches_by_path` (the U-Net
    # paths of phases 17, 21, 23, 25, 26, 29 and 33 launch none).
    def totals(rows, weights):
        by_stage = {r["stage"]: r for r in rows}
        tot = {key: sum(by_stage[st][key] * n for st, n in weights.items())
               for key in ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms")}
        return {"ms": tot["ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
                **bound_fields(tot["flop_ms"], tot["byte_ms"])}

    def timed(rows, mode, dtype="float32"):
        return [r for r in rows if r["mode"] == mode and "ms" in r and r.get("dtype", "float32") == dtype]

    step_2d = {m: {st[0]: 2 * st[4][m] for st in STAGES_2D if m in st[4]} for m in PER_FORWARD_2D}
    units = {
        "fwd": {"region": totals(timed(per_shape, "region"), PER_FORWARD["region"]),
                "none": totals(timed(fwd_rows_2d, "none"), step_2d["none"]),
                "mask": totals(timed(fwd_rows_2d, "mask"), step_2d["mask"])},
        "bwd": {"region": totals(timed(bwd_rows, "region"), BWD_PER_STEP_BY_STAGE["region"]),
                "none": totals(timed(bwd_rows_2d, "none"), step_2d["none"]),
                "mask": totals(timed(bwd_rows_2d, "mask"), step_2d["mask"])},
    }
    ref_224 = {m: {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms")}
               for m in PER_FORWARD_2D for r in timed(fwd_rows_2d, m) if r["stage"] == REF_STAGE_2D[0]}
    sup_2d = {m: {st[0]: st[4][m] for st in STAGES_SWIN_SUP if m in st[4]} for m in PER_FORWARD_SWIN_SUP}
    sup_3d_fwd = {m: {st: 2 * n for st, n in PER_FORWARD[m].items()} for m in ("none", "region")}
    paths = {
        "fwd": {"none": {"swinunetr_inference_forward": totals(timed(per_shape, "none"), PER_FORWARD["none"]),
                         "swinunet2d_224_w7_stage1_launch": ref_224["none"],
                         "swinunet2d_supervised_step": totals(
                             [r for r in sup_rows["fwd2d"] if r["mode"] == "none"], sup_2d["none"]),
                         "swinunetr_supervised_step_bf16": totals(
                             [r for r in sup_rows["fwd3d"] if r["mode"] == "none"], sup_3d_fwd["none"])},
                "mask": {"swinunet2d_224_w7_stage1_launch": ref_224["mask"],
                         "swinunet2d_supervised_step": totals(
                             [r for r in sup_rows["fwd2d"] if r["mode"] == "mask"], sup_2d["mask"])},
                "region": {"swinunetr_supervised_step_bf16": totals(
                    [r for r in sup_rows["fwd3d"] if r["mode"] == "region"], sup_3d_fwd["region"])}},
        "bwd": {"none": {"swinunetr_training_step": totals(timed(bwd_rows, "none"),
                                                           BWD_PER_STEP_BY_STAGE["none"]),
                         "swinunetr_icl_fs24_training_step": totals(timed(new["kernels"]["bwd"], "none"),
                                                                    BWD_PER_STEP_BY_STAGE["none"]),
                         "swinunet2d_supervised_step": totals(
                             [r for r in sup_rows["bwd2d"] if r["mode"] == "none"], sup_2d["none"]),
                         "swinunetr_supervised_step_bf16": totals(
                             [r for r in sup_rows["bwd3d"] if r["mode"] == "none"], PER_FORWARD["none"])},
                "mask": {"swinunet2d_supervised_step": totals(
                    [r for r in sup_rows["bwd2d"] if r["mode"] == "mask"], sup_2d["mask"])},
                "region": {"swinunetr_supervised_step_bf16": totals(
                    [r for r in sup_rows["bwd3d"] if r["mode"] == "region"], PER_FORWARD["region"]),
                    "swinunetr_icl_fs24_training_step": totals(timed(new["kernels"]["bwd"], "region"),
                                                               BWD_PER_STEP_BY_STAGE["region"])}},
    }
    for mode in ("none", "region"):  # fs24 (head dim 8), fs192 (64) beside the fs48 units
        paths["fwd"][mode]["swinunetr_fs24_inference_forward"] = totals(
            timed(new["kernels"]["fwd"], mode), PER_FORWARD[mode])
        paths["fwd"][mode]["swinunetr_fs192_inference_forward"] = totals(
            timed(tile64["kernels"]["fwd"], mode), PER_FORWARD[mode])
        paths["fwd"][mode]["swinunetr_fs192_inference_forward_bf16"] = totals(
            timed(tile64["kernels"]["fwd"], mode, "bfloat16"), PER_FORWARD[mode])
        paths["bwd"][mode]["swinunetr_icl_fs192_training_step"] = totals(
            timed(tile64["kernels"]["bwd"], mode), BWD_PER_STEP_BY_STAGE[mode])
        # head dims 80 and 128: two 64-column chunks (fs384 at stage 1 alone)
        paths["fwd"][mode]["swinunetr_fs240_inference_forward"] = totals(
            timed(wide["kernels"]["fwd_fs240"], mode), PER_FORWARD[mode])
        paths["fwd"][mode]["swinunetr_fs240_inference_forward_bf16"] = totals(
            timed(wide["kernels"]["fwd_fs240"], mode, "bfloat16"), PER_FORWARD[mode])
        paths["fwd"][mode]["swinunetr_icl_fs240_training_step"] = totals(
            timed(wide["kernels"]["fwd_fs240_step"], mode), FWD_PER_STEP_BY_STAGE[mode])
        paths["fwd"][mode]["swinunetr_icl_fs240_training_step_bf16"] = totals(
            timed(wide["kernels"]["fwd_fs240_step"], mode, "bfloat16"), FWD_PER_STEP_BY_STAGE[mode])
        paths["bwd"][mode]["swinunetr_icl_fs240_training_step"] = totals(
            timed(wide["kernels"]["bwd_fs240"], mode), BWD_PER_STEP_BY_STAGE[mode])
        for direction in ("fwd", "bwd"):
            for r in timed(wide["kernels"][f"{direction}_fs384"], mode):
                paths[direction][mode][f"swinunetr_fs384_{r['stage']}_launch"] = {
                    k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    for direction in ("fwd", "bwd"):  # the 2D stage-1 shapes at head dim 64, a launch each
        for r in timed(tile64["kernels"][f"{direction}2d"], "none") + timed(tile64["kernels"][f"{direction}2d"],
                                                                               "mask"):
            paths[direction].setdefault(r["mode"], {})[f"swinunet2d_d64_{r['stage']}_launch"] = {
                k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        for r in timed(wide["kernels"][f"{direction}2d"], "none") + timed(wide["kernels"][f"{direction}2d"],
                                                                             "mask"):
            paths[direction].setdefault(r["mode"], {})[f"swinunet2d_d128_{r['stage']}_launch"] = {
                k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    per = {"region": {"fwd": "SwinUNETR inference forward", "bwd": "SwinUNETR-ICL training step"},
           "none": "Swin-UNet-ICL training step", "mask": "Swin-UNet-ICL training step"}
    kernels = []
    for direction, source, rows_3d, rows_2d in (("fwd", "window_attention", per_shape, fwd_rows_2d),
                                                ("bwd", "window_attention_bwd", bwd_rows, bwd_rows_2d)):
        for mode in ("none", "region", "mask"):
            by_path = {"training_3d": training["path_launches"][direction][mode],
                       "training_2d": training_2d["path_launches"][direction][mode],
                       "training_unet_2d": training_unet["path_launches"][direction][mode],
                       "training_unet_3d_brats": training_unet3d["path_launches"][direction][mode],
                       "training_unet_3d_brats_supervised":
                           supervised_unet3d["path_launches"][direction][mode],
                       "training_unet_3d_amos": amos_icl["path_launches"][direction][mode],
                       "training_unet_3d_amos_supervised":
                           amos_sup["path_launches"][direction][mode],
                       "training_unet_2d_supervised": sup_unet["path_launches"][direction][mode],
                       "training_swinunet_2d_supervised":
                           sup_swinunet["path_launches"][direction][mode],
                       "training_swinunetr_3d_supervised":
                           sup_swinunetr["path_launches"][direction][mode],
                       "training_fixmatch_cta_2d": cta["path_launches"][direction][mode],
                       "training_fast_unet_2d": fast["run_launches"][direction][mode],
                       "training_unet_2d_grad_accum": accum["path_launches"][direction][mode],
                       "training_fixmatch_cta_swinunet_2d": cta_swin["cli"]["path_launches"][direction][mode],
                       "validation_fixmatch_cta_swinunet_2d":
                           cta_swin["val_launches"][direction].get(mode, 0),
                       "graph_swinunet_2d_supervised_first_step":
                           graph["swin_first_step"][direction][mode]}
            by_path["training_3d_fs24"] = new["fs24"]["path_launches"][direction][mode]
            by_path["training_3d_fs192"] = tile64["fs192"]["path_launches"][direction][mode]
            by_path["training_3d_fs240_bf16"] = wide["fs240"]["path_launches"][direction][mode]
            if direction == "fwd":
                by_path["inference_3d"] = launches.get(mode, 0)
                by_path["inference_3d_two_ranks"] = dp_window["launches"][mode]
            for r, counts in enumerate(tp["swin"]["launches"]):
                by_path[f"training_swinunetr_3d_tp2_rank{r}"] = counts[direction][mode]
            for r, counts in enumerate(tp["swin"]["val_launches"]):
                by_path[f"validation_swinunetr_3d_tp2_rank{r}"] = counts[direction].get(mode, 0)
            held = (rows_3d + rows_2d + new["kernels"][direction] + new["kernels"]["sweep"][direction]
                    + tile64["kernels"][direction] + tile64["kernels"][f"{direction}2d"]
                    + tile64["kernels"]["sweep"][direction] + wide["kernels"][f"{direction}2d"]
                    + [r for fs in (FS240, FS384) for r in wide["kernels"][f"{direction}_fs{fs}"]]
                    + (wide["kernels"]["fwd_fs240_step"] + wide["kernels"]["fwd_above_two"]
                       if direction == "fwd" else []))
            errs = [r["max_abs_err"] for r in held if r["mode"] == mode
                    and (direction == "bwd" or r["dtype"] == "float32")]
            head_dims = sorted({r["shape"][3] for r in held if r["mode"] == mode})
            kernels.append({
                "name": f"{source}[{mode}]",
                "route": "cuda",
                "source": f"icl_tpu_torch/ops/csrc/{source}.cu",
                "replaces": REPLACES[mode] if direction == "fwd" else BWD_REPLACES,
                "launches": by_path["training_3d" if mode == "region" else "training_2d"],
                "launches_by_path": by_path,
                "max_abs_err": max(errs),
                "head_dims": head_dims,
                "head_dims_card_tests": list(CARD_TEST_HEAD_DIMS),
                **units[direction][mode],
                "per": per[mode][direction] if mode == "region" else per[mode],
                "paths": paths[direction].get(mode, {}),
            })
    # The streamed kernels, a mode each. `launches`: no mask and mask those of
    # phase 62's CLI run (Swin-UNet-ICL 2D at head dim 192, 3 steps), region
    # those of phase 61's one-head SwinUNETR path (its sliding window, and
    # its backward pass). Times per launch: no mask and mask at the 2D stage
    # 1 [512, 1, 144, 192] (the shift mask), region at fs432's stage 1 (the
    # inference forward's [1372, 3, 343, 144]; the backward at the training
    # pass's [686, 3, 343, 144]); the other timed shapes under `paths`.
    srows, one = stream["kernels"], stream["kernels"]["one_head"]
    for direction, source in (("fwd", "window_attention_stream"), ("bwd", "window_attention_bwd_stream")):
        for mode in ("none", "region", "mask"):
            timed_rows = [r for r in srows[direction] if r["mode"] == mode and "ms" in r]
            unit_stage = ("fs432_stage1" if direction == "fwd" else "fs432_train_stage1") if mode == "region" \
                else "2d_d192_stage1"
            unit = next(r for r in timed_rows if r["stage"] == unit_stage)
            one_head = "inference_3d_fs48_one_head" if direction == "fwd" else "training_pass_3d_fs48_one_head"
            by_path = {"training_2d_d192": stream["d192"]["path_launches_by_route_mode"][direction]["stream"][mode],
                       one_head: one[f"{direction}_stream_by_mode"][mode]}
            launches = by_path[one_head if mode == "region" else "training_2d_d192"]
            errs = [r["max_abs_err"] for r in srows[direction] if r["mode"] == mode
                    and (direction == "bwd" or r["dtype"] == "float32")]
            kernels.append({
                "name": f"{source}[{mode}]",
                "route": "cuda",
                "source": f"icl_tpu_torch/ops/csrc/{source}.cu",
                "replaces": REPLACES[mode] if direction == "fwd" else BWD_REPLACES,
                "launches": launches,
                "launches_by_path": by_path,
                "max_abs_err": max(errs),
                "head_dims": sorted({r["shape"][3] for r in srows[direction] if r["mode"] == mode}),
                "head_dims_card_tests": list(CARD_TEST_STREAM_HEAD_DIMS),
                **{k: unit[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                "per": f"one launch at {unit['shape']}",
                "paths": {f"{r['stage']}_launch": {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                                    "bound_ms", "bound_by")}
                          for r in timed_rows if r is not unit},
            })
    kernels.append({
        "name": "sgd_bf16", "route": "cuda", "source": "icl_tpu_torch/ops/csrc/sgd_bf16.cu",
        "replaces": SGD_REPLACES, "launches": fast["launches"],
        "launches_by_path": {"training_fast_unet_2d": fast["launches"],
                             "training_swinunetr_icl_bf16_state_remat_step":
                                 new["bf16_remat"]["one_step"]["launches"]["remat"]["sgd_bf16"],
                             "training_unet_2d_bf16_two_ranks": dp["sgd_bf16_launches"],
                             **{f"training_unet_2d_bf16_tp2_rank{r}": n
                                for r, n in enumerate(tp["flagship"]["sgd_bf16_launches"])}},
        "launches_per_replayed_step": fast["per_replay"]["sgd_bf16"], "replays": fast["replays"],
        "max_abs_err": sgd_row["max_abs_err"], "ms": sgd_row["ms"], "device_ms": sgd_row["device_ms"],
        "plain_ms": sgd_row["plain_ms"], "bound_ms": sgd_row["bound_ms"],
        "bound_by": sgd_row["bound_by"], "library_ms": sgd_row["library_ms"],
        "f32_polysgd_ms": sgd_row["f32_polysgd_ms"], "largest_leaf_ms": sgd_row["largest_leaf_ms"],
        "largest_leaf_bound_ms": sgd_row["largest_leaf_bound_ms"],
        "largest_leaf_plain_ms": sgd_row["largest_leaf_plain_ms"],
        "largest_leaf_library_ms": sgd_row["largest_leaf_library_ms"],
        "per": f"the flagship's SGD update, {sgd_row['leaves']} leaves, {sgd_row['parameters']} "
               "parameters; library_ms is torch.optim.SGD(fused=True) on the same bf16 tensors "
               "(round-to-nearest stores)"})
    print(f"[summary] chip_smoke.py: every phase passed in {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dp_worker(sys.argv[2:]) if sys.argv[1:2] == ["--dp-worker"] else main(sys.argv[1:]))
