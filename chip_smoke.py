#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fairmultimodal_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. card: the name and power limit from ``nvidia-smi``;
2. build: every kernel compiled from ``fairmultimodal_torch/ops/csrc``, and
   what ``-Xptxas -v`` reports (registers, stack, spills) for each
   instantiation of the persistent bf16 "nt" GEMM, the wgmma "nn" / "tn"
   GEMM, the wgmma flash forward, dQ and dK / dV kernels, the fp32 CUDA-core
   GEMMs and the fp32 flash forward, dQ and dK / dV kernels (the bf16 "nt",
   fp32 GEMMs and wgmma flash kernels may not spill);
3. kernels: each ported kernel's wrapper against its plain PyTorch version
   on the card, at the shapes the serving path gives it, in fp32 (max abs
   error <= 1e-4: only the summation order differs) and in bf16 (max abs
   <= 0.125 and mean abs <= 2e-3: the outputs are LayerNorm outputs with
   |y| < 8, where a bf16 ulp is at most 0.03125; the two versions round the
   same intermediates but sum in another order, so a rounding can flip by
   an ulp and carry through the residual and the LayerNorm); then timed with
   CUDA events (median of 10 after warm-up) beside the plain version, one
   PyTorch library composition of the same function (F.linear + SDPA +
   layer_norm; never called by the port) and the card's bound, and each of
   the half-layer's kernel launches timed alone the same way; one more
   attention shape off the serving path (head dim 12, ragged S) is checked
   for errors only, so every code path of the attention kernels runs;
4. slice: the serving main path at full width -- a bf16 FAME model (demo
   BERT 12L/12H, lab encoder 2L/8H over 549 labs, H 768) and a BERT-base
   note encoder, seeded random weights, a 300-patient cohort whose notes hit
   every bucket -- through ``encode_note_chunks`` -> ``build_arrays``
   -> ``FAMEPredictor.predict_arrays``, with the kernels' launch counts read
   around it; then the same model in fp32 on 8 patients on the card and on
   the CPU (probabilities within 1e-4); then ``FAMEPredictor.benchmark``.

3b. training kernels: forward-with-residuals plus backward of both
   half-layers through their ops' autograd (``fm::``) against the plain forward
   plus the plain backward on the card, at the lab shapes (attention B256
   S560 8x96, FFN R143360 F2048 relu), fp32 and bf16, dropout off and at
   rate 0.1 (the same Philox seed, so the same masks); limits per grad,
   relative to that grad's largest entry: fp32 1e-4 (only summation order
   differs), bf16 see ``TRAIN_BF16_MAX`` / ``TRAIN_BF16_MEAN``.  Dropout:
   every stream keeps 0.9 +- 0.001 of its elements, the same seed gives
   bit-identical outputs and another seed another mask.  The gelu branch of
   the FFN backward is checked for errors at a reduced text shape, and both
   backwards at a shape off the main path (600 rows, S 200, head dim 12, a
   fully masked row).  Timed
   (bf16, dropout on, CUDA-event medians): the forward with residuals, the
   backward, each backward launch alone, the plain backward and one library
   composition's backward (torch autograd of F.linear + SDPA + dropout +
   layer_norm; never called by the port), beside the bound.  Every fp32
   backward (and the timed bf16 one) runs twice on the same inputs and must
   leave bit-identical grads;
5. training slice: ``FAMETrainer.fit`` for 2 epochs at full width in bf16
   (batch 256, 1024 train / 256 validation synthetic patients, dropout on),
   with the kernels' launch counts read around it; then one fp32 train step
   on 8 patients on the card and on the CPU with the same generator seed
   (loss within 1e-5 relative, every grad within 1e-3 of its max-abs); then
   the train-step time at batch 256 bf16 (median of 20 after warm-up) and its
   device time by kernel from ``torch.profiler``.

3c. unfolded kernels (the layer with ``fold_ln=False``): ``fused_attention_block``
   (Pallas #5 / #6) and ``fused_ffn`` (#7 / #8) forward and backward through
   their ops' autograd (``fm::``) against the plain forward and backward, at
   the lab shapes (B256 S560 8x96; R143360 F2048 relu with the inner dropout
   off and at 0.1) and at a text shape (R 64 x 512, F 3072, gelu), fp32 and
   bf16, plus shapes off the main path (S 272, head dim 64, a fully masked
   row; 600 rows); the dropout + residual + LayerNorm glue against its plain
   version; limits at the phase.  Timed in bf16: each forward and backward
   launch, plain versions, one library composition of each (F.linear x3 +
   SDPA + F.linear; F.linear + relu + dropout + F.linear; their autograd
   backwards), beside the bound.  Then each bf16 "nt" GEMM stage of the path
   alone (QKV, Wo into bf16 and fp32, W1 with relu + inner dropout + aux, W2
   at K 2048, the text encoder's S-512 QKV; errors only: the text W1 with
   gelu and a ragged M 600 / N 200 / K 96) against the same epilogue in fp32,
   timed beside F.linear with the TFLOP/s of each, and the W1 launch with a
   bias of +8 (no pre-activation near zero) zeroing exactly the elements the
   plain Philox mask drops; then each bf16 backward product of the lab path
   alone ("nn": dO, dx with and without the fp32 residual, dh with the relu
   gate and its column partials, the FFN's dx; "tn" split-K: dWo, dWqkv, dW1,
   dW2; errors only: the text dgelu gate with aux and ragged M 600 / N 200
   shapes) against the same epilogue in fp32, timed beside torch.matmul.
   The backwards of #3, #4, #6 and #8 (every fp32 case, the timed bf16 one)
   run twice on the same inputs and must leave bit-identical grads (no float
   atomics).  Then each fp32 product of the lab path at the pipelines'
   batch 16 (R 8960: "nt" QKV / Wo / W1 with relu + dropout + aux / W2, "nn"
   dO / dx + residual / gated dh / FFN dx, "tn" dWo / dWqkv / dW1 / dW2
   split-K; errors only: the text gelu / dgelu stages, ragged shapes and the
   lab dWqkv over 143360 rows) against the same product in float64 on the
   card (within 1e-5 of max-abs, which TF32 misses), timed beside F.linear /
   torch.matmul in fp32 with TF32 off;
5b. unfolded slice: an fp32 train step unfolded on the card against the
   folded one on the card (loss 1e-6 relative, grads 1e-4 of max-abs) and
   against the CPU plain path (phase 5's limits); ``FAMETrainer.fit`` for 1
   epoch with validation under ``FMTPU_FOLD_LN=0`` (512 train / 256
   validation patients, full width) whose launch counts of #5-#8 and of the
   glue must equal the protocol's, with #1-#4 never launched; the bf16
   train step at batch 256 folded and unfolded in turns and the unfolded
   one's profiler split; fp32 serving probabilities unfolded vs folded
   (1e-5) and ``FAMEPredictor.benchmark`` unfolded.

3d. flash kernels (Pallas #9 / #10, the flash route): ``flash_attention``
   forward and backward (dq, dk, dv) through its op's autograd against
   ``flash_attention_reference`` / ``flash_attention_backward_reference`` on
   the card, fp32 and bf16, at the lab shape (B256 S560 8x96, q/k/v head
   views of three [B, S, H] Dense outputs, 549 of 560 keys, the mask
   expanded as BEHRTLab builds it), the text-train shape (B32 S512 12x64,
   per-row masks, a fully masked row) and off the main path (d 32 at S 256
   without a mask; d 128 at S 1024 on contiguous [B, heads, S, d] tensors;
   the packed ``fused_qkv`` layout; #1's packed layout at B 16, d 96; d 20
   at S 200, whose 40-byte head stride TMA cannot read, so the bf16 wrapper
   copies q, k, v, o and dO padded); limits at the phase.  Every fp32
   forward is also held against float64 within 1e-5 of max-abs (IEEE fp32;
   a fully masked row against the mean of v).
   In bf16 the backward is also held against its own rounding order
   repeated in PyTorch: at most 1% of the entries differ, by at most one
   bf16 ulp of max-abs.  Timed in bf16 at the lab shape (B 256) and in fp32
   at the pipelines' lab shape (B 16) and the text shape (B 32, S 512, 12 x
   64): the kernels (the bf16 backward's dQ and dK / dV kernels also apart,
   from the profiler), their plain versions, SDPA with the -1e9 bias (the
   kernel it runs named by the profiler) and its autograd backward (never
   called by the port), beside the bound; the backward run twice (every
   fp32 case, the timed bf16 one) must give bit-identical dq, dk, dv.
   Also ``TorchEncoderLayer(fused_qkv=True)`` against the same layer unfused
   in fp32 (forward and grads 1e-4 of max-abs);
5c. flash-route slice (``attn_kernel=False`` on every lab layer): an fp32
   train step with dropout on against the folded card step and the CPU
   plain path (phase 5's limits); ``FAMETrainer.fit`` for 1 epoch (512 train
   / 256 validation patients, full width) whose launch counts of #9, #10,
   ``fused_ffn_ln`` and the glue must equal the protocol's, with #1 / #3 /
   #5 / #6 never launched; the bf16 train step at batch 256 folded and on
   the flash route in turns and the flash route's profiler split; fp32
   serving probabilities flash route vs folded (1e-4) and
   ``FAMEPredictor.benchmark`` on the flash route.

6. the FAME experiment: ``run_fame_bundle`` (the pipeline without pandas) on a
   seeded synthetic 2048-patient ``FeatureBundle`` (phase 4's notes, labels
   at prevalences 0.12 / 0.25 / 0.45) at the reference geometry in bf16,
   BERT-base text encoder from a seeded random init, ``device_data=True``,
   2 epochs at batch 256, into a temporary directory.  It fails unless the
   launches of #1-#4 equal the counts worked out from the text buckets, the
   loaders' lengths, the epochs and the eval passes (every other kernel 0);
   the three metric blocks are there with finite AUROC / AP; the thresholds
   lie on the 101-point grid; every artifact is written (the extracted
   vectors with the reference keys and shapes); the saved
   ``best_model_<ts>.npz``, read back by the port's reader into
   ``FAMEPredictor``, gives the run's test probabilities within 1e-3; and one
   shuffled epoch of ``DeviceLoader`` batches on the card is bit-identical to
   ``BatchIterator`` batches moved by ``to_device``, pad rows zero.  Prints
   the stage times and the train patients/s of each epoch.

7. the command line: ``fairmultimodal_torch.cli.main`` called in-process at
   the reference geometry in bf16 on ``--synthetic 2048 --synthetic_labs
   549`` (550 lab columns with ``icu_los``) at batch 256, every call with
   ``--require_hf_weights --text_cache``.  First a Bio_ClinicalBERT snapshot
   of BERT-base geometry with seeded random weights is written into a hub
   cache under ``build/phase7/`` (``HF_HUB_CACHE``): ``config.json``,
   ``tokenizer_config.json``, a BertForPreTraining-named
   ``pytorch_model.bin`` and a ``vocab.txt`` that spells most note words in
   single characters, so the chunks reach the 256 and 512 buckets.  Runs:
   A ``fame --epochs 2 --checkpoint_dir CA``; B ``fame --epochs 1
   --checkpoint_dir CB`` reading the same cohort from CSV files written by
   ``write_csv_table`` (``--data_dir``); C ``fame --epochs 2
   --checkpoint_dir CB``, which resumes; D ``predict --params`` A's npz; E
   ``fame --runs 2 --epochs 1``.  It fails unless every run's launches of
   #1-#4 equal the counts predicted before the runs from the snapshot's
   tokenizer and the split (every other kernel 0); only A and E's second
   seed encode text (the rest hit the cache); C prints the resume line and
   its ``step_2`` (and B's ``step_1``) equals A's bit for bit; D's
   probabilities for A's test patients lie within 1e-3 of sigmoid of A's
   extracted test logits; E prints the Table-3 block and writes
   ``runs_aggregate.csv``.  ``build/phase7/`` is removed at the end.  Prints
   each run's wall time and stage times, the checkpoint's size and its save
   and restore seconds, the tokenizer's chunks/s and the text stage cold
   and warm.

8. the baselines: ``cli.main`` in-process on phase 7's cohort and a snapshot
   written as phase 7 writes it (under ``build/phase8/``, removed at the
   end), every run ``--epochs 1 --require_hf_weights --text_cache`` at the
   pipelines' own batch 16: ``behrt --bf16``, ``behrt`` (fp32, its default
   dtype), ``bioclinicalbert`` (fp32), ``average --bf16``, ``sigmoid
   --bf16``, ``eddi --bf16``.  It fails unless each run's launches of #1-#4
   equal the counts worked out before the runs from the splits, the
   loaders' lengths and the text buckets (every other kernel 0; 07 launches
   none); every metric block has a finite AUROC and AUPRC; each run's split
   equals the one worked out beforehand (09's by the port's copy of
   scikit-learn's split); 07 writes ``extracted_embeddings.npz`` with one
   512-wide row per patient kept; 08 reports finite [3, 3] weights.  Then
   one fp32 train step of each of the five models at full width on 16
   patients (for 08 its loss and backward), card against CPU from the same
   weights and generator seed (the loss within phase 5's limit of the CPU;
   every grad leaf within phase 5's limit of the float64 step beyond the
   CPU's own fp32 error against it), each model initialised once for the
   three steps; the 01 train step at batch
   16 in bf16 and fp32 (CUDA-event median of 10) and profiled; FAME's
   default step (``FAMETrainer.train_step`` at the reference geometry in
   fp32, ``TrainConfig``'s batch 16, dropout 0.1: what ``fame`` runs without
   --bf16), timed and profiled the same way; 07's bf16 step with and without
   dropout (the share its int64 Philox dropout takes); #1-#4 at the
   baselines' shape B 16 x S 560 in fp32 and bf16 against their plain
   versions, timed beside the plain version, one library composition and
   the bound (fp32 against the CUDA cores' 67 TFLOP/s), #1's four forward
   launches one by one beside F.linear / SDPA / F.linear / dropout + add +
   F.layer_norm, the backwards also stage by stage and run twice for the
   same bits; and #5-#10 at that shape in fp32, timed the same way.  The
   fp32 step of 09 also replays its lab layers stage by stage on the card
   (the kernels from the card step's inputs, float64 from the float64
   step's) against the CPU fp32 step: every activation, the relu gates of
   W1 that flip against float64 and the split of
   ``behrt_lab.layer_0.ffn_in.weight``'s error over W1's rows with and
   without a flipped gate; its grads are held by the lab encoder's rule
   (``lab_grad_rule``: every activation within 1e-5 of float64's max-abs,
   every flip within 1e-5 of max |h| of zero, the card's flips at most 4x
   the CPU's (counted as at least 2), then phase 8's rule with the rows a
   flipped gate writes set to float64 and W1 / b1 within 0.1 of the limit).  Prints each run's
   wall time, stage times and train patients per second of the train
   stage (which holds the epoch's validation pass too).

9. the remaining baselines: ``cli.main`` in-process on phase 7's cohort and a
   snapshot written as phase 7 writes it (under ``build/phase9/``, removed
   at the end), each at full width in fp32, batch 16, ``--epochs 1``:
   ``dfc``, ``fairehrclp`` (its reference behaviour, 07's model) and
   ``legacy-eddi`` with ``--require_hf_weights --text_cache``, and
   ``legacy-behrt --synthetic 2048`` (``make_admission_frame``); then 06's
   contrastive mode through ``run_fairehr_clp_experiment(contrastive=True)``
   (the command line has no flag for it).  It fails unless each run's
   launches of #1-#4, the unfolded kernels, the glue and the flash kernels
   equal the counts worked out before the runs from the splits and the
   loaders' lengths (03, 06 and legacy-behrt none of #1-#4; legacy-eddi's two
   lab layers #1-#4; the contrastive encoder #2 / #4 and the glue in two
   layers for two views; legacy-behrt's glue in 12 BERT layers per train
   step); every metric block has a finite AUROC and AUPRC; each run's split
   equals the one worked out beforehand.  Then one fp32 train step of each
   new model at full width (03's DfC, 06's FairEHR-CLP with its contrastive
   term, ``LegacyEDDIFull``, ``BEHRTSequence`` and 08's bare
   ``EDDIFusionModel``; on 16 patients, the three that launch no counted
   kernel on 4), card against CPU by phase 8's rule (legacy-eddi's lab
   layers replayed and held by the lab encoder's rule, as 09's in phase 8);
   each step timed at batch 16
   (CUDA-event median of 5) and profiled, legacy-behrt's also without
   dropout (the share of its int64 Philox dropout); and #2 / #4 alone at
   the contrastive encoder's shape (R 8784 = 16 x 549, 48 rows past a
   multiple of 128, H 256, F 512) in fp32 and bf16 against their plain
   versions (fp32: forward within FP32_TOL, grads within TRAIN_FP32_TOL of
   max-abs), the backward twice for the same bits, timed beside the plain
   version, one library composition and the bound, with each GEMM stage at
   that shape alone (fp32 against float64, bf16 against fp32).  Prints each
   run's wall time and stage times.

10. 04 adv_debias: ``run_adv_debias_experiment`` on phase 7's cohort and a
   snapshot written as phase 7 writes it (under ``build/phase10/``, removed
   at the end) at full width in fp32, batch 16, 1 epoch, text at 128, stage 2
   on the 549 raw lab columns over two points of ``REFERENCE_GRID``'s values
   (``ADV_GRID``: 200 iterations at widths 64 and 128, adversary 32, dropout
   0.3).  It fails unless every counted kernel launches 0 times (07's model
   runs its BERT at one token, the text stays below 256, stage 2 is two
   MLPs); the split equals iterstrat's worked out beforehand; the matched
   and resampled row counts equal the numpy functions' on the same y and z;
   every stage-1 AUROC / AUPRC is finite and every stage-2 metric that the
   validation split defines is; each point's and the final npz files and a
   2-row ``metrics.csv`` in the JAX columns are written; each reloaded
   predictor gives the run's validation probabilities within 1e-6; and
   ``check_finite_tree`` finds nothing in either network.  Then ``cli.main(
   ["advdebias", "--tiny", ...])`` in-process (its artifacts, no launch);
   ``train_adversarial`` for 20 iterations at dropout 0 on the card and the
   CPU from the same weights against the same iterations in float64 (each
   parameter and the loss curve within 1e-4 of max-abs beyond the CPU
   fp32's own error; no launch); and one stage-2 iteration at widths 64 and
   128, dropout 0.3 and 0, timed with ``utils/profiling.Timer`` (median of
   200 after 20) and profiled with ``profile_to`` / ``hlo_self_times``
   (device busy, idle share, launches per iteration), with what the full
   64-point ``REFERENCE_GRID`` would take at those rates.

11. the MIMIC-III ETL (``data/etl.py``; no pandas on the card):
   ``write_raw_mimic(400, seed=0)`` through ``run_etl`` on the card against
   ``run_etl`` on the CPU, native scanners on and off, by ``etl_rule`` (each
   of the five CSVs: columns, dtypes and rows equal, text and integers
   exact, floats within 1e-12 of the column's max-abs); a second card run
   byte-identical to the first; ``cli.main(["data", "--synthetic", "40"])``
   in-process against the CPU; then ``write_raw_mimic_scaled(n_subjects=3000,
   chartevents_rows=500_000)`` (a fortieth of ``ETL_BENCH_r05.log``'s rows)
   through ``python -m fairmultimodal_torch.cli data --timing --use_native
   on`` and ``off``, each in its own process under the profiler (per-table
   rows/s, stage seconds, the card's busy share, peak device memory and peak
   RSS), the two paths held to each other by the rule.  Every counted kernel
   must launch 0 times (work files under ``build/phase11/``, removed at the
   end).

12. data parallelism (``fairmultimodal_torch/parallel``): the card has one
   H100 and NCCL refuses two ranks on one device, so two gloo ranks share
   ``cuda:0`` (``parallel.launch`` spawns them; ``get_mesh(2, devices=["cuda:0"]
   * 2, backend="gloo")``) and one NCCL rank runs the command line.  In the
   ranks (``dp_rank``), at the reference geometry in fp32 on a global batch of
   16: (a) one deterministic step against one process's on the same rows and
   weights (phase 5's limits); the two trajectories' drift over 20
   deterministic steps (parameters and probe probabilities, reported); (b) three
   dropout steps with the parameters bit-identical across the ranks after
   each, the backward bit-identical twice, and #2 with each rank's folded
   64-bit seeds against its plain version (FP32_TOL), the ranks' outputs
   different; (c) #1-#4 launched as worked out (2 / 2 for a step, 6 / 6 for
   three, the text encode's count, 132 / 48 for the experiment), the rest
   never; (d) the dynamic-weight statistics bit-identical to one process's;
   (e) ``encode_note_chunks`` sharded over the ranks within 1e-5 of max-abs of
   one process; (f) ``run_fame_experiment`` 1 epoch on phase 7's 2048-patient
   cohort with ``deterministic_forward`` at a global batch of 64 (24 steps; 32
   rows per rank): finite AUROC / AUPRC, the splits,
   every artifact written once by rank 0, rank 1 silent, and the test
   probabilities within 3x the drift of one process against itself with the
   LayerNorm unfolded (``DP_ORDER_FACTOR``; both runs in this phase).  In the
   parent: that one-process run and its unfolded twin, ``cli fame --mesh 1``
   (NCCL, world 1, ``fame``'s batch 16; 500 / 190 launches, finite metrics,
   artifacts once),
   and (g) FAME's default step at no mesh and NCCL world 1 in turns with the
   profiler's busy / idle split, beside the two ranks' step on one card.

13. tensor parallelism (``parallel.shard_params_tp``, ``DEFAULT_TP_RULES``):
   #9 / #10 at the sharded lab layer's shape (B 16, 4 local heads of 96) and
   #7 / #8 at its 1024 local columns (R 8960, inner dropout 0.1), fp32, against
   their plain versions and timed; then two gloo ranks on ``cuda:0`` as a
   1 x 2 mesh (``tp_rank``; NCCL refuses two ranks on one device) at the
   reference geometry in fp32: (a) the eval loss of the sharded parameters
   within 2e-5 relative of one process's (the JAX package's limit) and one
   deterministic step of batch 16 by phase 5's limits, the grads gathered
   over the model group, the worst leaf recorded -- against one process on
   the sharded layers' route (the flash route, #7 / #8 and the glue: the
   same kernels but the split reduction), with the W1 rows, b1 entries and
   positional rows of the relu gates that the two runs set otherwise (each
   within REPLAY_FLIP_TOL of zero) set to one process's values, as phase 8's
   ``lab_grad_rule`` does; against the default folded one (#1-#4) the
   numbers are recorded; (b) after three dropout
   steps the replicated parameters bit-identical across the ranks and the
   shards different, the backward bit-identical twice, #7 with each rank's
   inner seed (folded with the model index) different between the ranks and
   the glue with the shared outer seed equal, each within FP32_TOL of its
   plain version; (c) the launches of #7-#10 and the glue per rank equal to
   the counts worked out before the run, #1-#6 never; (d) one epoch of
   ``run_fame_experiment`` on phase 7's cohort at a global batch of 64:
   finite metrics, rank 0 alone writes and prints, the npz holds full-size
   parameters, and the test probabilities within 3x the drift of phase 12's
   one process against itself with the LayerNorm unfolded (its runs and
   text cache are reused) of one process on the sharded route that sums
   each row-parallel product from the same two K halves (``same_route_run``
   with ``split``); one process on the route unsplit (whose launches equal
   each rank's), the folded one and the saved parameters scored with equal
   dynamic weights are recorded; (e) parameter bytes and peak memory per rank
   against one process, and the step time of the two ranks (CUDA-event
   median of 5).

14. the kernels as torch ops (``fm::``, ``ops/_library.py``) and FAME's step
   captured into CUDA graphs: (a) ``torch.library.opcheck`` on CUDA tensors
   for every op, fp32 and bf16, at small shapes with dropout on; (b) each op
   pair (forward with its residuals, backward by autograd) captured at the lab
   layer's geometry at batch 2, fp32 and bf16, its keys the device slots that
   the graph's first node copies from pinned host memory: three replays, each
   with fresh seeds and bit for bit the eager call with those seeds as ints;
   on the last two the dropping ops run on inputs that show each mask (a zero
   residual, a unit bias), whose kept elements are exactly ``dropout_mask``'s;
   (c) FAME's step -- forward, loss, backward and ``clip_grad_norm_``, the
   AdamW update left eager -- captured with a ``KeyTape`` in place of the
   dropout generator, fp32 at batch 16 (the default run) and bf16 at batch 256
   (phase 5's), folded: three replays with fresh seeds, each against the eager
   step from the same generator state, the losses and every grad bit for bit;
   (d) the replay against the eager step, CUDA-event medians in turns.

It prints a ``{"kernels": [...]}`` line that keeps each kernel's required keys
and its launches per phase (the LN-fused kernels' phase 6, 7, 8 and 9
launches, every kernel's phase 10, 11, 12 (``launches_dp``: rank 0, rank 1 of
the two-rank experiment, the ``--mesh 1`` command line) and 13
(``launches_tp``: each rank of the 1 x 2 experiment), and #7 / #9's times at
the sharded shape); the full rows (errors by case, stages, phase 8's times
at B 16, #2 / #4's at 06's shape, every shape) go to
``chiprun_out/chip_smoke_kernels.json``.  Then one ``[summary]`` line per
phase (ok, seconds, key numbers), the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
HBM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s
FP32_PEAK = 67e12         # H100 SXM dense fp32 FLOP/s outside the tensor cores
FP32_TOL = 1e-4
BF16_MAX_TOL, BF16_MEAN_TOL = 0.125, 2e-3
N_PATIENTS, N_LABS = 300, 549
CHUNK_WORDS = (30, 100, 200, 450)   # -> buckets 64, 128, 256, 512


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops, nbytes, peak=BF16_PEAK):
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# -- phase 3: kernels against their plain versions --------------------------------


def attention_case(fab, B, S, H, nh, eps, mask_kind, dtype, gen):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    x = rn(B, S, H)
    w = []
    for _ in range(4):
        w += [rn(H, H, std=H ** -0.5), rn(H, std=0.02)]
    gamma = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda"))
    beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
    if mask_kind == "lab":      # 549 real lab tokens padded to 560
        mask = (torch.arange(S, device="cuda") < N_LABS).int()[None].expand(B, S).contiguous()
    else:                       # note lengths; zero rows are the padded batch tail
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
        lens[-2:] = 0
        mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).int()
    args = (x, *w, gamma, beta, mask)
    kw = dict(num_heads=nh, ln_eps=eps)
    run = lambda: fab.fused_attention_block_ln_infer(*args, **kw)
    plain = lambda: fab.fused_attention_block_ln_reference(*args, **kw)

    wqkv = torch.cat(w[0:6:2])
    bqkv = torch.cat(w[1:6:2])
    bias = torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]
    d = H // nh

    def library():
        qkv = torch.nn.functional.linear(x, wqkv, bqkv).view(B, S, 3, nh, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        y = torch.nn.functional.linear(o.transpose(1, 2).reshape(B, S, H), w[6], w[7])
        return torch.nn.functional.layer_norm(x + y, (H,), gamma.to(dtype), beta.to(dtype),
                                              eps)

    flops = B * (8 * S * H * H + 4 * S * S * H)
    nbytes = 2 * B * S * H * x.element_size() + 4 * H * H * x.element_size() + B * S * 4
    stages = lambda: fab.half_layer_stages(*args, **kw)[0]
    return run, plain, library, stages, flops, nbytes


def ffn_case(ffn, R, H, F, act, eps, dtype, gen):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    x = rn(R, H)
    w1, b1, w2, b2 = rn(F, H, std=H ** -0.5), rn(F, std=0.02), rn(H, F, std=F ** -0.5), rn(H, std=0.02)
    gamma = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda"))
    beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
    args = (x, w1, b1, w2, b2, gamma, beta)
    kw = dict(activation=act, ln_eps=eps)
    run = lambda: ffn.fused_ffn_ln_infer(*args, **kw)
    plain = lambda: ffn.fused_ffn_ln_reference(*args, **kw)
    fact = torch.relu if act == "relu" else torch.nn.functional.gelu

    def library():
        y = torch.nn.functional.linear(fact(torch.nn.functional.linear(x, w1, b1)), w2, b2)
        return torch.nn.functional.layer_norm(x + y, (H,), gamma.to(dtype), beta.to(dtype),
                                              eps)

    flops = 4 * R * H * F
    nbytes = 2 * R * H * x.element_size() + 2 * H * F * x.element_size()
    stages = lambda: ffn.half_layer_stages(*args, **kw)[0]
    return run, plain, library, stages, flops, nbytes


def check_errors(name, label, dtype, run, plain):
    """Max and mean abs error of the kernel against its plain version."""
    out = run()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} {label} {dtype}: non-finite output")
    err = (out.float() - plain().float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    if dtype == torch.float32 and max_err > FP32_TOL:
        raise AssertionError(f"{name} {label} fp32: max abs err {max_err} > {FP32_TOL}")
    if dtype == torch.bfloat16 and (max_err > BF16_MAX_TOL or mean_err > BF16_MEAN_TOL):
        raise AssertionError(f"{name} {label} bf16: max {max_err} mean {mean_err}")
    return max_err, mean_err


def kernel_phase(fab, ffn):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("fused_attention_block_ln", "lab B256 S560 8x96", "attn",
         dict(B=256, S=560, H=768, nh=8, eps=1e-5, mask_kind="lab")),
        ("fused_attention_block_ln", "text B32 S512 12x64", "attn",
         dict(B=32, S=512, H=768, nh=12, eps=1e-12, mask_kind="text")),
        ("fused_attention_block_ln", "text B64 S256 12x64", "attn",
         dict(B=64, S=256, H=768, nh=12, eps=1e-12, mask_kind="text")),
        ("fused_ffn_ln", "lab R143360 F2048 relu", "ffn",
         dict(R=256 * 560, H=768, F=2048, act="relu", eps=1e-5)),
        ("fused_ffn_ln", "text R16384 F3072 gelu", "ffn",
         dict(R=32 * 512, H=768, F=3072, act="gelu", eps=1e-12)),
    ]
    results = []
    for name, label, kind, shape in cases:
        row = {"kernel": name, "shape": label}
        for dtype in (torch.float32, torch.bfloat16):
            make = attention_case if kind == "attn" else ffn_case
            mod = fab if kind == "attn" else ffn
            run, plain, library, stages, flops, nbytes = make(mod, **shape, dtype=dtype, gen=gen)
            with torch.inference_mode():
                tag = "fp32" if dtype == torch.float32 else "bf16"
                row[f"max_abs_err_{tag}"], row[f"mean_abs_err_{tag}"] = \
                    check_errors(name, label, dtype, run, plain)
                if dtype == torch.bfloat16:
                    row["ms"] = time_ms(run)
                    row["plain_ms"] = time_ms(plain)
                    row["library_ms"] = time_ms(library)
                    row["stages_ms"] = {stage: time_ms(fn) for stage, fn in stages()}
                    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
                    row["flops"], row["bytes"] = flops, nbytes
            del run, plain, library, stages
            torch.cuda.empty_cache()
        log(f"[kernels] {json.dumps(row)}")
        results.append(row)

    # Off the serving path: head dim 12 (a 24-byte head stride TMA cannot
    # read, so the bf16 wrapper copies q, k, v padded; DP 32) and S 200 (a
    # ragged last key tile), errors only.
    label = "B4 S200 64x12"
    for dtype in (torch.float32, torch.bfloat16):
        run, plain, *_ = attention_case(fab, B=4, S=200, H=768, nh=64, eps=1e-12,
                                        mask_kind="text", dtype=dtype, gen=gen)
        with torch.inference_mode():
            errs = check_errors("fused_attention_block_ln", label, dtype, run, plain)
        log(f"[kernels] fused_attention_block_ln {label} {dtype}: max/mean abs err {errs}")
    return results


# -- phase 3b: the training kernels against their plain versions ------------------------

# bf16 limits, relative to each grad's largest entry.  Kernel and plain
# version round the same intermediates (da / dy, dO, p, ds * scale, dq / dk
# / dv, dh) to bf16 but sum their fp32 products in another order (the
# tensor cores' fp32 accumulation is not the CUDA cores'), so a rounding can
# land one bf16 ulp (2^-8 relative) apart and carry through a product with
# thousands of terms.  In the FFN a pre-activation within that noise of zero
# can also fall on the other side of the relu mask (a few hundred of the
# 2.9e8 elements), which moves dx of its row by one term dh * W1: the tail of
# dx reaches about 3% of its largest entry there, while every mean stays
# near 1e-5.  A missing rounding point or a wrong dropout mask moves the
# mean by orders of magnitude.
TRAIN_FP32_TOL = 1e-4
TRAIN_BF16_MAX, TRAIN_BF16_MEAN = 2.0 ** -4, 2.0 ** -10
KEEP_TOL = 1e-3
ATTN_GRADS = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dgamma", "dbeta")
FFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta")


def _leaves(tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _attn_train_case(fab, B, S, H, nh, eps, dtype, gen, L):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    x = rn(B, S, H)
    w = []
    for _ in range(4):
        w += [rn(H, H, std=H ** -0.5), rn(H, std=0.02)]
    gamma = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
    mask = (torch.arange(S, device="cuda") < L).int()[None].expand(B, S).contiguous()
    if B < 8:
        mask[-1] = 0      # a padded batch row: every key masked
    g = rn(B, S, H)
    return [x, *w, gamma, beta], mask, g


def _grouped_attn(grads):
    """(dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dgamma, dbeta) -> the
    port's buffers: dW and db of q | k | v as one tensor each."""
    dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dgamma, dbeta = grads
    return dict(zip(ATTN_GRADS, (dx, torch.cat((dwq, dwk, dwv)), torch.cat((dbq, dbk, dbv)),
                                 dwo, dbo, dgamma, dbeta)))


def _compare(label, dtype, got, want):
    """Max / mean abs error of each grad, checked against the limits."""
    rows = {}
    for name, w in want.items():
        a, b = got[name].float(), w.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {name} not finite")
        err = (a - b).abs()
        scale = max(b.abs().max().item(), 1e-30)
        mx, mean = err.max().item(), err.mean().item()
        rows[name] = {"max_abs_err": mx, "mean_abs_err": mean, "max_abs": scale}
        if dtype == torch.float32:
            ok = mx <= TRAIN_FP32_TOL * scale
        else:
            ok = mx <= TRAIN_BF16_MAX * scale and mean <= TRAIN_BF16_MEAN * scale
        if not ok:
            raise AssertionError(f"{label}: {name} max {mx} mean {mean} (max-abs {scale})")
    return rows


def _time_backward(out, leaves, g):
    """CUDA-event median of the backward alone (the forward's graph kept)."""
    return time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))


def attention_train_check(fab, _build, gen, dtype, rate, B=256, S=560, H=768, nh=8, eps=1e-5,
                          L=N_LABS, timed=False, peak=BF16_PEAK):
    inputs, mask, g = _attn_train_case(fab, B, S, H, nh, eps, dtype, gen, L)
    seed = 1234 if rate else None
    kw = dict(num_heads=nh, ln_eps=eps)
    leaves = _leaves(inputs)
    out = fab.fused_attention_block_ln(*leaves, mask, rate=rate, deterministic=not rate,
                                       seed=seed, **kw)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=timed)
    with torch.no_grad():
        out_p, res = fab.fused_attention_block_ln_reference(*inputs, mask, rate=rate, seed=seed,
                                                            return_residuals=True, **kw)
        x, wq, _, wk, _, wv, _, wo, _, gamma, _ = inputs
        plain = lambda: fab.fused_attention_block_ln_backward_reference(  # noqa: E731
            g, x, res["qkv"], res["o"], res["z"], wq, wk, wv, wo, gamma, mask, rate=rate,
            seed=seed, **kw)
        grads_p = plain()
    label = f"attention B{B} S{S} {H // nh}x{nh} {dtype} rate {rate}"
    errs = _compare(label, dtype, {"out": out, **_grouped_attn(grads)},
                    {"out": out_p, **_grouped_attn(grads_p)})
    row = {"case": label, "errors": errs}
    if rate:
        row["same_seed_identical"] = bool(torch.equal(out, fab.fused_attention_block_ln(
            *inputs, mask, rate=rate, deterministic=False, seed=seed, **kw)))
        row["other_seed_differs"] = not torch.equal(out, fab.fused_attention_block_ln(
            *inputs, mask, rate=rate, deterministic=False, seed=seed + 1, **kw))
        if not (row["same_seed_identical"] and row["other_seed_differs"]):
            raise AssertionError(f"{label}: dropout not reproducible per seed {row}")
    if timed or dtype == torch.float32:    # every fp32 backward, and the timed bf16 one
        from fairmultimodal_torch.utils.rng import Dropout
        drop = _keyed(Dropout.make(seed, 0, rate))
        with torch.no_grad():
            fwd, _, saved = fab.half_layer_stages(*inputs, mask, dropout=drop, residuals=True,
                                                  **kw)
            for _, fn in fwd:
                fn()
            bwd, bwd_grads = fab.backward_stages(g, saved, inputs[7], inputs[9], dropout=drop,
                                                 **kw)
            row["deterministic"] = _runs_bit_identical(lambda: fab._run(bwd), bwd_grads)
            if not row["deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            if timed:
                row["fwd_res_ms"] = time_ms(lambda: [fn() for _, fn in fwd])
                row["fwd_stages"] = _attention_fwd_stages(fwd, inputs, mask, nh, eps, rate)
                row["ms"] = time_ms(lambda: [fn() for _, fn in bwd])
                row["stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
                row["plain_ms"] = time_ms(plain, reps=5)
        del fwd, saved, bwd, bwd_grads
    if timed:
        row["library_ms"] = _attention_library_bwd_ms(inputs, mask, g, nh, eps, rate)
        flops = B * (16 * S * H * H + 8 * S * S * H)
        nbytes = (8 * B * S * H + 4 * H * H) * x.element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, peak)
        row["flops"], row["bytes"] = flops, nbytes
    del out, grads, grads_p, res
    torch.cuda.empty_cache()
    return row


def _attention_fwd_stages(fwd, inputs, mask, nh, eps, rate):
    """#1's forward launches timed one by one (with residuals, as a train step
    runs them), each beside the one PyTorch call that does the same work: the
    QKV and Wo GEMMs beside F.linear, the flash forward beside SDPA with the
    -1e9 bias on the same head views, dropout + residual + LayerNorm beside
    F.dropout + add + F.layer_norm; with each product's TFLOP/s."""
    F = torch.nn.functional
    x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = inputs
    B, S, H = x.shape
    d = H // nh
    w_qkv, b_qkv = torch.cat((wq, wk, wv)), torch.cat((bq, bk, bv))
    qkv = F.linear(x, w_qkv, b_qkv)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(B, S, 3, nh, d).unbind(2))
    bias = torch.where(mask > 0, 0.0, -1e9).to(x.dtype)[:, None, None, :]
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias).transpose(1, 2).reshape(B, S, H)
    y = F.linear(o, wo, bo)
    library = {
        "qkv_gemm": (lambda: F.linear(x, w_qkv, b_qkv), 6 * B * S * H * H),
        "flash_attn_fwd": (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
                           4 * B * S * S * H),
        "wo_gemm": (lambda: F.linear(o, wo, bo), 2 * B * S * H * H),
        "add_layernorm": (lambda: F.layer_norm(x + F.dropout(y, rate), (H,), gamma.to(x.dtype),
                                               beta.to(x.dtype), eps), 0),
    }
    rows = {}
    for name, fn in fwd:
        lib, flops = library[name]
        r = {"ms": time_ms(fn), "library_ms": time_ms(lib)}
        if flops:
            r["tflops"], r["library_tflops"] = (flops / r[k] / 1e9 for k in ("ms", "library_ms"))
        rows[name] = r
    del qkv, q, k, v, o, y, library
    return rows


def _attention_library_bwd_ms(inputs, mask, g, nh, eps, rate):
    F = torch.nn.functional
    leaves = _leaves(inputs)
    x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = leaves
    B, S, H = x.shape
    d = H // nh
    bias = torch.where(mask > 0, 0.0, -1e9).to(x.dtype)[:, None, None, :]
    qkv = F.linear(x, torch.cat((wq, wk, wv)), torch.cat((bq, bk, bv))).view(B, S, 3, nh, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    y = F.dropout(F.linear(o.transpose(1, 2).reshape(B, S, H), wo, bo), rate)
    out = F.layer_norm(x + y, (H,), gamma.to(x.dtype), beta.to(x.dtype), eps)
    return _time_backward(out, leaves, g)


def ffn_train_check(ffn, _build, gen, dtype, rate, R=256 * 560, H=768, F=2048, act="relu",
                    eps=1e-5, timed=False, peak=BF16_PEAK):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    inputs = [rn(R, H), rn(F, H, std=H ** -0.5), rn(F, std=0.02), rn(H, F, std=F ** -0.5),
              rn(H, std=0.02), 1 + 0.1 * torch.randn(H, generator=gen, device="cuda"),
              0.1 * torch.randn(H, generator=gen, device="cuda")]
    g = rn(R, H)
    seeds = (21, 22) if rate else None
    kw = dict(activation=act, ln_eps=eps)
    leaves = _leaves(inputs)
    out = ffn.fused_ffn_ln(*leaves, rate=rate, deterministic=not rate, seeds=seeds, **kw)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=timed)
    with torch.no_grad():
        out_p, res = ffn.fused_ffn_ln_reference(*inputs, rate=rate, seeds=seeds,
                                                return_residuals=True, **kw)
        plain = lambda: ffn.fused_ffn_ln_backward_reference(  # noqa: E731
            g, inputs[0], res["hd"], res["z"], inputs[1], inputs[3], inputs[5], rate=rate,
            seeds=seeds, **kw)
        grads_p = plain()
    label = f"ffn R{R} F{F} {act} {dtype} rate {rate}"
    errs = _compare(label, dtype, {"out": out, **dict(zip(FFN_GRADS, grads))},
                    {"out": out_p, **dict(zip(FFN_GRADS, grads_p))})
    row = {"case": label, "errors": errs}
    if rate:
        again = ffn.fused_ffn_ln(*inputs, rate=rate, deterministic=False, seeds=seeds, **kw)
        other = ffn.fused_ffn_ln(*inputs, rate=rate, deterministic=False,
                                 seeds=(seeds[0] + 7, seeds[1] + 7), **kw)
        row["same_seed_identical"] = bool(torch.equal(out, again))
        row["other_seed_differs"] = not torch.equal(out, other)
        if not (row["same_seed_identical"] and row["other_seed_differs"]):
            raise AssertionError(f"{label}: dropout not reproducible per seed {row}")
    if timed or dtype == torch.float32:    # every fp32 backward, and the timed bf16 one
        inner, outer = map(_keyed, ffn._streams(seeds, rate, act))
        with torch.no_grad():
            fwd, _, saved = ffn.half_layer_stages(*inputs, inner=inner, outer=outer,
                                                  residuals=True, **kw)
            for _, fn in fwd:
                fn()
            bwd, bwd_grads = ffn.backward_stages(g, saved, inputs[1], inputs[3], inputs[5],
                                                 outer=outer, inv_keep=inner.inv_keep, **kw)
            row["deterministic"] = _runs_bit_identical(lambda: ffn._run(bwd), bwd_grads)
            if not row["deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            if timed:
                row["fwd_res_ms"] = time_ms(lambda: [fn() for _, fn in fwd])
                row["ms"] = time_ms(lambda: [fn() for _, fn in bwd])
                row["stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
                row["plain_ms"] = time_ms(plain, reps=5)
        del fwd, saved, bwd, bwd_grads
    if timed:
        row["library_ms"] = _ffn_library_bwd_ms(inputs, g, act, eps, rate)
        flops = 8 * R * H * F
        nbytes = (4 * R * H + R * F + 2 * H * F) * inputs[0].element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, peak)
        row["flops"], row["bytes"] = flops, nbytes
    del out, grads, grads_p, res
    torch.cuda.empty_cache()
    return row


def _ffn_library_bwd_ms(inputs, g, act, eps, rate):
    F = torch.nn.functional
    leaves = _leaves(inputs)
    x, w1, b1, w2, b2, gamma, beta = leaves
    fact = F.relu if act == "relu" else F.gelu
    y = F.dropout(F.linear(F.dropout(fact(F.linear(x, w1, b1)), rate), w2, b2), rate)
    out = F.layer_norm(x + y, (x.shape[1],), gamma.to(x.dtype), beta.to(x.dtype), eps)
    return _time_backward(out, leaves, g)


def dropout_keep_fractions(rng_mod):
    """Kept fraction of each Philox stream of the lab layer at rate 0.1:
    attention output and FFN outer [R, H], FFN inner [R, F]."""
    R, H, F = 256 * 560, 768, 2048
    fr = {}
    for name, seed, stream, shape in (("attn_out", 1234, 0, (R, H)), ("ffn_inner", 21, 0, (R, F)),
                                      ("ffn_outer", 22, 1, (R, H))):
        fr[name] = rng_mod.dropout_mask(seed, stream, shape, 0.1, "cuda").float().mean().item()
        if abs(fr[name] - 0.9) > KEEP_TOL:
            raise AssertionError(f"dropout stream {name}: kept fraction {fr[name]}")
    return fr


def train_kernel_phase(fab, ffn, _build):
    from fairmultimodal_torch.utils import rng as rng_mod

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"attention": [], "ffn": []}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            timed = dtype == torch.bfloat16 and rate > 0
            for kind, check, mod in (("attention", attention_train_check, fab),
                                     ("ffn", ffn_train_check, ffn)):
                row = check(mod, _build, gen, dtype, rate, timed=timed)
                log(f"[train-kernels] {json.dumps(row)}")
                rows[kind].append(row)
        # gelu branch of the FFN backward, errors only, at a reduced text shape
        for rate in (0.0, 0.1):
            row = ffn_train_check(ffn, _build, gen, dtype, rate, R=8 * 512, F=3072, act="gelu",
                                  eps=1e-12)
            log(f"[train-kernels] {json.dumps(row)}")
        # Off the main path, errors only: 600 rows (a weight-grad reduction
        # with a ragged last slice), S 200 (a ragged key / query tile) and
        # head dim 12 (element loads, head pad 32), with a fully masked row.
        row = attention_train_check(fab, _build, gen, dtype, 0.1, B=3, S=200, nh=64, L=190,
                                    eps=1e-12)
        log(f"[train-kernels] {json.dumps(row)}")
        row = ffn_train_check(ffn, _build, gen, dtype, 0.1, R=600)
        log(f"[train-kernels] {json.dumps(row)}")
    keep = dropout_keep_fractions(rng_mod)
    log(f"[train-kernels] kept fractions at rate 0.1: {json.dumps(keep)}")
    return rows, keep


# -- phase 3c: the unfolded kernels (Pallas #5-#8) against their plain versions -------------
#
# Limits: fp32 forward max abs error FP32_TOL (only summation order differs);
# every bf16 output and every grad against the limits of _compare, relative
# to its largest entry (TRAIN_FP32_TOL; bf16 TRAIN_BF16_MAX / TRAIN_BF16_MEAN,
# for the reason given there: the same intermediates are rounded to bf16 on
# both sides, summed in another order).  The glue's LayerNorm outputs take
# phase 3's bf16 limits.

BLOCK_GRADS = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
UFFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2")


def _grouped_block(grads):
    dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo = grads
    return dict(zip(BLOCK_GRADS, (dx, torch.cat((dwq, dwk, dwv)), torch.cat((dbq, dbk, dbv)),
                                  dwo, dbo)))


def _runs_bit_identical(run, outs):
    """Whether ``run()`` twice leaves the same bits in ``outs`` (no float
    atomics: the sums are taken in a fixed order)."""
    run()
    first = [t.clone() for t in outs]
    run()
    return all(torch.equal(a, b) for a, b in zip(first, outs))


def _check_forward(label, dtype, out, want):
    if dtype == torch.float32:
        err = (out.float() - want.float()).abs()
        if not torch.isfinite(out).all() or err.max().item() > FP32_TOL:
            raise AssertionError(f"{label}: forward max abs err {err.max().item()}")
        return {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item()}
    return _compare(label, dtype, {"out": out}, {"out": want})["out"]


def block_check(fab, gen, dtype, B=256, S=560, H=768, nh=8, L=N_LABS, timed=False,
                peak=BF16_PEAK):
    """#5 and #6 through ``fused_attention_block`` and its op's autograd
    against the plain forward and backward."""
    inputs, mask, g = _attn_train_case(fab, B, S, H, nh, 0.0, dtype, gen, L)
    inputs = inputs[:9]                       # x and the four projections, no LayerNorm
    x, wq, _, wk, _, wv, _, wo, _ = inputs
    kw = dict(num_heads=nh)
    label = f"block B{B} S{S} {H // nh}x{nh} {dtype}"
    with torch.no_grad():
        out_p, res = fab.fused_attention_block_reference(*inputs, mask, return_residuals=True,
                                                         **kw)
        fwd = _check_forward(label, dtype, fab.fused_attention_block(*inputs, mask, **kw), out_p)
    leaves = _leaves(inputs)
    out = fab.fused_attention_block(*leaves, mask, **kw)
    grads = torch.autograd.grad(out, leaves, g)
    plain = lambda: fab.fused_attention_block_backward_reference(   # noqa: E731
        g, x, res["qkv"], res["o"], wq, wk, wv, wo, mask, **kw)
    with torch.no_grad():
        grads_p = plain()
    errs = _compare(label, dtype, {"out": out, **_grouped_block(grads)},
                    {"out": out_p, **_grouped_block(grads_p)})
    row = {"case": label, "forward": fwd, "errors": errs}
    del out, grads, grads_p
    if not timed and dtype == torch.float32:   # the timed run repeats its backward below
        with torch.no_grad():
            fwd_res, _, saved = fab.block_stages(*inputs, mask, residuals=True, **kw)
            fab._run(fwd_res)
            bwd, bwd_grads = fab.block_backward_stages(g, saved, wo, **kw)
            row["bwd_deterministic"] = _runs_bit_identical(lambda: fab._run(bwd), bwd_grads)
        if not row["bwd_deterministic"]:
            raise AssertionError(f"{label}: two backward runs differ")
        del fwd_res, saved, bwd, bwd_grads
    if timed:
        F = torch.nn.functional
        d = H // nh
        bias = torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]

        def library(xx, q_w, q_b, k_w, k_b, v_w, v_b, o_w, o_b):
            qkv = F.linear(xx, torch.cat((q_w, k_w, v_w)), torch.cat((q_b, k_b, v_b)))
            q, k, v = (t.transpose(1, 2) for t in qkv.view(B, S, 3, nh, d).unbind(2))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            return F.linear(o.transpose(1, 2).reshape(B, S, H), o_w, o_b)

        with torch.no_grad():
            infer, _, _ = fab.block_stages(*inputs, mask, **kw)
            fwd_res, _, saved = fab.block_stages(*inputs, mask, residuals=True, **kw)
            fab._run(fwd_res)
            bwd, bwd_grads = fab.block_backward_stages(g, saved, wo, **kw)
            row["ms"] = time_ms(lambda: fab._run(infer))
            row["stages_ms"] = {name: time_ms(fn) for name, fn in infer}
            row["fwd_res_ms"] = time_ms(lambda: fab._run(fwd_res))
            row["bwd_ms"] = time_ms(lambda: fab._run(bwd))
            row["bwd_stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
            row["bwd_deterministic"] = _runs_bit_identical(lambda: fab._run(bwd), bwd_grads)
            if not row["bwd_deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            row["plain_ms"] = time_ms(lambda: fab.fused_attention_block_reference(
                *inputs, mask, **kw), reps=5)
            row["plain_bwd_ms"] = time_ms(plain, reps=5)
            row["library_ms"] = time_ms(lambda: library(*inputs))
        lib_leaves = _leaves(inputs)
        row["library_bwd_ms"] = _time_backward(library(*lib_leaves), lib_leaves, g)
        e = x.element_size()
        flops = B * (8 * S * H * H + 4 * S * S * H)
        nbytes = 2 * B * S * H * e + 4 * H * H * e + B * S * 4
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, peak)
        flops_b = B * (16 * S * H * H + 8 * S * S * H)
        nbytes_b = (7 * B * S * H + 8 * H * H) * e
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(flops_b, nbytes_b, peak)
        row["flops"], row["bytes"], row["bwd_flops"], row["bwd_bytes"] = \
            flops, nbytes, flops_b, nbytes_b
        del saved, fwd_res, bwd, infer, lib_leaves
    del res, out_p
    torch.cuda.empty_cache()
    return row


def unfolded_ffn_check(ffn, gen, dtype, rate, R=256 * 560, H=768, F=2048, act="relu",
                       timed=False, peak=BF16_PEAK):
    """#7 and #8 through ``fused_ffn`` and its op's autograd against the
    plain forward and backward, with the inner dropout at ``rate``."""
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    inputs = [rn(R, H), rn(F, H, std=H ** -0.5), rn(F, std=0.02), rn(H, F, std=F ** -0.5),
              rn(H, std=0.02)]
    x, w1, b1, w2, b2 = inputs
    g = rn(R, H)
    seed = 21 if rate else None
    kw = dict(activation=act, rate=rate)
    label = f"ffn R{R} F{F} {act} {dtype} rate {rate}"
    with torch.no_grad():
        out_p, res = ffn.fused_ffn_reference(*inputs, seed=seed, return_residuals=True, **kw)
        fwd = _check_forward(label, dtype, ffn.fused_ffn(*inputs, deterministic=not rate,
                                                        seed=seed, **kw), out_p)
    leaves = _leaves(inputs)
    out = ffn.fused_ffn(*leaves, deterministic=not rate, seed=seed, **kw)
    grads = torch.autograd.grad(out, leaves, g)
    plain = lambda: ffn.fused_ffn_backward_reference(g, x, res["hd"], w1, w2,   # noqa: E731
                                                     seed=seed, **kw)
    with torch.no_grad():
        grads_p = plain()
    errs = _compare(label, dtype, {"out": out, **dict(zip(UFFN_GRADS, grads))},
                    {"out": out_p, **dict(zip(UFFN_GRADS, grads_p))})
    row = {"case": label, "forward": fwd, "errors": errs}
    if rate:
        with torch.no_grad():
            again = ffn.fused_ffn(*inputs, deterministic=False, seed=seed, **kw)
            other = ffn.fused_ffn(*inputs, deterministic=False, seed=seed + 7, **kw)
        row["same_seed_identical"] = bool(torch.equal(out, again))
        row["other_seed_differs"] = not torch.equal(out, other)
        if not (row["same_seed_identical"] and row["other_seed_differs"]):
            raise AssertionError(f"{label}: dropout not reproducible per seed {row}")
        del again, other
    del out, grads, grads_p
    inner = _keyed(ffn._inner_stream(seed, rate, not rate, act))
    if timed or dtype == torch.float32:    # every fp32 backward, and the timed bf16 one
        with torch.no_grad():
            fwd_res, _, saved = ffn.ffn_stages(*inputs, activation=act, inner=inner,
                                               residuals=True)
            ffn._run(fwd_res)
            bwd, bwd_grads = ffn.ffn_backward_stages(g, saved, w1, w2, activation=act,
                                                     inv_keep=inner.inv_keep)
            row["bwd_deterministic"] = _runs_bit_identical(lambda: ffn._run(bwd), bwd_grads)
        if not row["bwd_deterministic"]:
            raise AssertionError(f"{label}: two backward runs differ")
        del bwd_grads
    if timed:
        Fn = torch.nn.functional
        fact = Fn.relu if act == "relu" else Fn.gelu

        def library(xx, a_w, a_b, b_w, b_b):
            return Fn.linear(Fn.dropout(fact(Fn.linear(xx, a_w, a_b)), rate), b_w, b_b)

        with torch.no_grad():
            infer, _, _ = ffn.ffn_stages(*inputs, activation=act, inner=inner)
            row["ms"] = time_ms(lambda: ffn._run(infer))
            row["stages_ms"] = {name: time_ms(fn) for name, fn in infer}
            row["fwd_res_ms"] = time_ms(lambda: ffn._run(fwd_res))
            row["bwd_ms"] = time_ms(lambda: ffn._run(bwd))
            row["bwd_stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
            row["plain_ms"] = time_ms(lambda: ffn.fused_ffn_reference(*inputs, seed=seed, **kw),
                                      reps=5)
            row["plain_bwd_ms"] = time_ms(plain, reps=5)
            row["library_ms"] = time_ms(lambda: library(*inputs))
        lib_leaves = _leaves(inputs)
        row["library_bwd_ms"] = _time_backward(library(*lib_leaves), lib_leaves, g)
        e = x.element_size()
        flops = 4 * R * H * F
        nbytes = (2 * R * H + 2 * H * F) * e
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, peak)
        flops_b = 8 * R * H * F
        nbytes_b = (3 * R * H + R * F + 4 * H * F) * e
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(flops_b, nbytes_b, peak)
        row["flops"], row["bytes"], row["bwd_flops"], row["bwd_bytes"] = \
            flops, nbytes, flops_b, nbytes_b
        del infer, lib_leaves
    if timed or dtype == torch.float32:
        del saved, fwd_res, bwd
    del res, out_p
    torch.cuda.empty_cache()
    return row


def glue_check(addnorm, gen, dtype, R=256 * 560, H=768, rate=0.1, timed=False):
    """The unfolded layer's dropout + residual + LayerNorm (the row kernels
    with y and dz in the io dtype) against its plain version."""
    from fairmultimodal_torch.utils.rng import Dropout

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    inputs = [rn(R, H), rn(R, H, std=0.3), 1 + 0.1 * torch.randn(H, generator=gen, device="cuda"),
              0.1 * torch.randn(H, generator=gen, device="cuda")]
    g = rn(R, H)
    kw = dict(eps=1e-5, dropout=Dropout.make(1234, 0, rate))
    label = f"dropout_add_layernorm R{R} {dtype} rate {rate}"
    with torch.no_grad():
        out = addnorm.dropout_add_layernorm(*inputs, **kw)
        want = addnorm.dropout_add_layernorm_reference(*inputs, **kw)
    errs = (out.float() - want.float()).abs()
    fwd = {"max_abs_err": errs.max().item(), "mean_abs_err": errs.mean().item()}
    lim = (FP32_TOL, 1.0) if dtype == torch.float32 else (BF16_MAX_TOL, BF16_MEAN_TOL)
    if fwd["max_abs_err"] > lim[0] or fwd["mean_abs_err"] > lim[1]:
        raise AssertionError(f"{label}: forward {fwd}")
    leaves = _leaves(inputs)
    grads = torch.autograd.grad(addnorm.dropout_add_layernorm(*leaves, **kw), leaves, g)
    leaves_p = _leaves(inputs)
    grads_p = torch.autograd.grad(addnorm.dropout_add_layernorm_reference(*leaves_p, **kw),
                                  leaves_p, g)
    names = ("dx", "dy", "dgamma", "dbeta")
    row = {"case": label, "forward": fwd,
           "errors": _compare(label, dtype, dict(zip(names, grads)), dict(zip(names, grads_p)))}
    if timed:
        with torch.no_grad():
            row["ms"] = time_ms(lambda: addnorm.dropout_add_layernorm(*inputs, **kw))
        row["bwd_ms"] = _time_backward(addnorm.dropout_add_layernorm(*leaves, **kw), leaves, g)
    del grads, grads_p, leaves, leaves_p
    torch.cuda.empty_cache()
    return row


def unfolded_kernel_phase(fab, ffn, addnorm):
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"block": [], "ffn": [], "glue": []}
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        cases = [("block", lambda: block_check(fab, gen, dtype, timed=timed)),
                 # off the main path: head dim 64, S 272, a fully masked row
                 ("block", lambda: block_check(fab, gen, dtype, B=4, S=272, nh=12, L=250)),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.0)),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.1, timed=timed)),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.0, R=64 * 512, F=3072,
                                                    act="gelu")),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.1, R=600)),
                 ("glue", lambda: glue_check(addnorm, gen, dtype, timed=timed))]
        for kind, check in cases:
            row = check()
            log(f"[unfolded-kernels] {json.dumps(row)}")
            rows[kind].append(row)
    return rows


# -- phase 3c, continued: each bf16 "nt" GEMM stage of the path beside F.linear -------------
#
# One launch of ``_build.gemm`` (layout "nt": csrc/gemm.cu::gemm_bf16_nt_kernel)
# at each shape the main path gives it (the lab layer at batch 256 and 16, the
# note encoder at S 512, a ragged stage), held against the same product and
# epilogue computed in fp32 on the card (TF32 off) and rounded once, and
# timed beside one ``F.linear`` on the same operands (cuBLAS; a yardstick the
# port never calls), each with its achieved TFLOP/s.  Limits, relative to the
# output's largest entry: bf16 out NT_BF16_MAX (one bf16 ulp: both round an
# fp32 sum of the same products, taken in another order) and mean
# TRAIN_BF16_MEAN; fp32 out NT_F32_TOL (summation order only).  Then the
# Philox mapping element for element: W1 with relu and inner dropout, its bias
# large enough that no pre-activation is near zero (relu zeroes nothing),
# must zero exactly the elements that ``utils.rng.dropout_mask`` drops.

NT_BF16_MAX, NT_F32_TOL = 2.0 ** -7, 1e-5
NT_SEED = 21
R_LAB, R_TEXT = 256 * 560, 32 * 512
R_B16 = 16 * N_LABS      # the baselines' batch 16: 69 row blocks of 128
# name, M, N, K, activation, inner-dropout rate, aux, fp32 out, timed
NT_STAGES = (
    ("qkv lab", R_LAB, 2304, 768, "none", 0.0, False, False, True),
    ("wo lab", R_LAB, 768, 768, "none", 0.0, False, False, True),
    ("wo lab fp32 out", R_LAB, 768, 768, "none", 0.0, False, True, True),
    ("w1 lab relu dropout aux", R_LAB, 2048, 768, "relu", 0.1, True, False, True),
    ("w2 lab", R_LAB, 768, 2048, "none", 0.0, False, False, True),
    ("qkv B16", R_B16, 2304, 768, "none", 0.0, False, False, True),
    ("w1 B16 relu dropout aux", R_B16, 2048, 768, "relu", 0.1, True, False, True),
    ("w2 B16 fp32 out", R_B16, 768, 2048, "none", 0.0, False, True, True),
    ("qkv text S512", R_TEXT, 2304, 768, "none", 0.0, False, False, True),
    ("w1 text gelu aux", R_TEXT, 3072, 768, "gelu", 0.0, True, False, True),
    ("ragged M600 N200 K96", 600, 200, 96, "relu", 0.1, True, False, False),
)


def _keyed(drop):
    """``drop`` with its seed as a key on the card, as the launchers take
    it (``ops/_library.key_of``)."""
    from fairmultimodal_torch.ops import _library

    return drop._replace(seed=_library.key_of(drop.seed, "cuda")) if drop.on else drop


def _nt_plain(a, w, bias, act, drop, out_dtype, compute=torch.float32):
    """The "nt" GEMM's epilogue in ``compute`` (fp32, or float64 for the fp32
    stages) on the same inputs: (out, aux)."""
    from fairmultimodal_torch.utils import rng

    pre = torch.addmm(bias.to(compute), a.to(compute), w.to(compute).t())
    v = torch.relu(pre) if act == "relu" else \
        torch.nn.functional.gelu(pre) if act == "gelu" else pre
    return rng.apply_dropout(v, drop).to(out_dtype), pre.to(a.dtype)


def _rel_errors(got, want):
    dt = torch.float64 if want.dtype == torch.float64 else torch.float32
    err = (got.to(dt) - want.to(dt)).abs()
    scale = max(want.to(dt).abs().max().item(), 1e-30)
    return {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "max_abs": scale}


def nt_gemm_check(_build, gen, name, M, N, K, act, rate, with_aux, out_f32, timed,
                  bias_shift=0.0):
    from fairmultimodal_torch.utils.rng import Dropout

    bf = torch.bfloat16
    a = torch.randn(M, K, generator=gen, device="cuda").to(bf)
    w = (torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5).to(bf)
    bias = 0.02 * torch.randn(N, generator=gen, device="cuda") + bias_shift
    drop = _keyed(Dropout.make(NT_SEED, 0, rate))
    out = torch.empty(M, N, device="cuda", dtype=torch.float32 if out_f32 else bf)
    aux = torch.empty(M, N, device="cuda", dtype=bf) if with_aux else None
    run = lambda: _build.gemm(a, w, out, bias=bias, activation=act, dropout=drop,  # noqa: E731
                              aux=aux)
    run()
    torch.cuda.synchronize()
    want, want_aux = _nt_plain(a, w, bias, act, drop, out.dtype)
    row = {"stage": name, "M": M, "N": N, "K": K, "activation": act, "dropout": rate,
           "out": "float32" if out_f32 else "bfloat16", "errors": _rel_errors(out, want)}
    checks = [("out", row["errors"])]
    if with_aux:
        row["aux_errors"] = _rel_errors(aux, want_aux)
        checks.append(("aux", row["aux_errors"]))
    for what, e in checks:
        if not torch.isfinite(out).all() or (
                e["max_abs_err"] > NT_F32_TOL * e["max_abs"] if out_f32 and what == "out" else
                e["max_abs_err"] > NT_BF16_MAX * e["max_abs"]
                or e["mean_abs_err"] > TRAIN_BF16_MEAN * e["max_abs"]):
            raise AssertionError(f"nt gemm {name}: {what} {e}")
    if bias_shift:
        kept = out != 0
        row["zeroed_as_plain"] = bool(torch.equal(kept, want != 0))
        row["kept_fraction"] = kept.float().mean().item()
        row["min_pre_activation"] = want_aux.float().min().item()
        if not row["min_pre_activation"] > 0 or not row["zeroed_as_plain"]:
            raise AssertionError(f"nt gemm {name}: dropout mask differs from the plain one {row}")
    del want, want_aux
    if timed:
        flops = 2 * M * N * K
        bias_io = bias.to(bf)
        row["ms"] = time_ms(run)
        row["tflops"] = flops / row["ms"] / 1e9
        row["library_ms"] = time_ms(lambda: torch.nn.functional.linear(a, w, bias_io))
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        nbytes = (M * K + N * K) * 2 + M * N * out.element_size() * (2 if with_aux else 1)
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    del a, w, out, aux
    torch.cuda.empty_cache()
    return row


def nt_gemm_phase(_build):
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for stage in NT_STAGES:
        row = nt_gemm_check(_build, gen, *stage)
        log(f"[nt-gemm] {json.dumps(row)}")
        rows.append(row)
    # The Philox mapping, element for element: no pre-activation near zero.
    row = nt_gemm_check(_build, gen, "w1 lab relu dropout, bias +8", R_LAB, 2048, 768, "relu", 0.1,
                        True, False, False, bias_shift=8.0)
    log(f"[nt-gemm] {json.dumps(row)}")
    rows.append(row)
    return rows


# -- phase 3c, continued: each bf16 "nn" / "tn" GEMM stage of the backward -----------------
#
# Each bf16 backward product of the lab path alone, at its shape (and the
# gated dh, dx + residual and a weight grad at batch 16): "nn" through
# ``_build.gemm`` (csrc/gemm.cu::gemm_bf16_nn_tn_kernel, persistent, with B
# MN-major) with the epilogue the path gives it, "tn" through
# ``fused_attention_block.weight_grad`` (the same kernel with both operands
# MN-major, split-K fp32 partials and their fixed-order sum), held against the
# same product and epilogue in fp32 on the card, rounded once.  Limits as the
# "nt" stages: NT_BF16_MAX (one bf16 ulp of max-abs) and mean TRAIN_BF16_MEAN;
# the gated stages' column sums (fp32, summed over 143360 rows in another
# order) TRAIN_FP32_TOL of their max-abs; the dgelu gate's aux
# (round(gelu(gate))) one bf16 ulp.  Timed beside one ``torch.matmul`` on the
# same operands (cuBLAS; a yardstick the port never calls), each with its
# TFLOP/s.

# name, layout, M, N, K, gate ("relu" | "dgelu" | None), fp32 residual, timed
NN_TN_STAGES = (
    ("dO attention", "nn", R_LAB, 768, 768, None, False, True),
    ("dx attention", "nn", R_LAB, 768, 2304, None, False, True),
    ("dx attention + resid", "nn", R_LAB, 768, 2304, None, True, True),
    ("dh ffn relu gate + colpart", "nn", R_LAB, 2048, 768, "relu", False, True),
    ("dx ffn", "nn", R_LAB, 768, 2048, None, False, True),
    ("dWo split-K", "tn", 768, 768, R_LAB, None, False, True),
    ("dWqkv split-K", "tn", 2304, 768, R_LAB, None, False, True),
    ("dW1 split-K", "tn", 2048, 768, R_LAB, None, False, True),
    ("dW2 split-K", "tn", 768, 2048, R_LAB, None, False, True),
    ("dh B16 relu gate + colpart", "nn", 16 * 560, 2048, 768, "relu", False, True),
    ("dx ffn B16 + resid", "nn", 16 * 560, 768, 2048, None, True, True),
    ("dW1 B16 split-K", "tn", 2048, 768, 16 * 560, None, False, True),
    ("dh text dgelu gate + aux", "nn", R_TEXT, 3072, 768, "dgelu", False, True),
    ("ragged nn M600 N200 K96 relu gate", "nn", 600, 200, 96, "relu", False, False),
    ("ragged tn M600 N200 K5000", "tn", 600, 200, 5000, None, False, False),
)
GATE_SCALE = 1.0 / 0.9     # the relu gate's 1 / keep with the inner dropout on


def _nn_tn_plain(layout, a, b, gate, gate_kind, resid, out_dtype, compute=torch.float32):
    """The product and its epilogue in ``compute`` (fp32, or float64 for the
    fp32 stages): (out, aux, column sums)."""
    a, b = a.to(compute), b.to(compute)
    v = a @ b if layout == "nn" else a.t() @ b
    aux = colsum = None
    if gate_kind == "relu":
        v = v * torch.where(gate > 0, GATE_SCALE, 0.0).to(compute)
    elif gate_kind == "dgelu":
        u = gate.to(compute)
        v = v * (0.5 * (1.0 + torch.erf(u * 0.70710678118654752))
                 + u * 0.3989422804014327 * torch.exp(-0.5 * u * u))
        aux = torch.nn.functional.gelu(u).to(gate.dtype)
    if resid is not None:
        v = v + resid
    if gate_kind:
        colsum = v.sum(dim=0)
    return v.to(out_dtype), aux, colsum


def nn_tn_gemm_check(_build, fab, gen, name, layout, M, N, K, gate_kind, with_resid, timed):
    bf = torch.bfloat16
    a_shape = (M, K) if layout == "nn" else (K, M)
    a = torch.randn(*a_shape, generator=gen, device="cuda").to(bf)
    b = (torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).to(bf)
    gate = torch.randn(M, N, generator=gen, device="cuda").to(bf) if gate_kind else None
    resid = torch.randn(M, N, generator=gen, device="cuda") if with_resid else None
    out = torch.empty(M, N, device="cuda", dtype=bf)
    aux = torch.empty(M, N, device="cuda", dtype=bf) if gate_kind == "dgelu" else None
    colpart = torch.empty(-(-M // 128), N, device="cuda") if gate_kind else None
    if layout == "tn":
        run = lambda: fab.weight_grad(a, b, out)  # noqa: E731
    else:
        run = lambda: _build.gemm(  # noqa: E731
            a, b, out, layout="nn", gate=gate, gate_kind=gate_kind,
            gate_scale=GATE_SCALE if gate_kind == "relu" else 1.0, aux=aux, resid=resid,
            colpart=colpart)
    run()
    torch.cuda.synchronize()
    want, want_aux, want_sum = _nn_tn_plain(layout, a, b, gate, gate_kind, resid, bf)
    row = {"stage": name, "layout": layout, "M": M, "N": N, "K": K, "gate": gate_kind,
           "resid": with_resid, "errors": _rel_errors(out, want)}
    if layout == "tn":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["splits"] = fab._splits(M, N, K, sms)
    checks = [("out", row["errors"], NT_BF16_MAX)]
    if aux is not None:
        row["aux_errors"] = _rel_errors(aux, want_aux)
        checks.append(("aux", row["aux_errors"], NT_BF16_MAX))
    if colpart is not None:
        row["colsum_errors"] = _rel_errors(colpart.sum(dim=0), want_sum)
        checks.append(("column sums", row["colsum_errors"], TRAIN_FP32_TOL))
    for what, e, lim in checks:
        if not torch.isfinite(out).all() or e["max_abs_err"] > lim * e["max_abs"] \
                or e["mean_abs_err"] > TRAIN_BF16_MEAN * e["max_abs"]:
            raise AssertionError(f"{layout} gemm {name}: {what} {e}")
    del want, want_aux, want_sum
    if timed:
        flops = 2 * M * N * K
        row["ms"] = time_ms(run)
        row["tflops"] = flops / row["ms"] / 1e9
        lib = (lambda: torch.matmul(a, b)) if layout == "nn" else (lambda: torch.matmul(a.t(), b))
        row["library_ms"] = time_ms(lib)
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        nbytes = (M * K + K * N + M * N) * 2 + (M * N * 2 if gate is not None else 0) \
            + (M * N * 4 if resid is not None else 0)
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    del a, b, gate, resid, out, aux, colpart
    torch.cuda.empty_cache()
    return row


def nn_tn_gemm_phase(_build, fab):
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for stage in NN_TN_STAGES:
        row = nn_tn_gemm_check(_build, fab, gen, *stage)
        log(f"[nn-tn-gemm] {json.dumps(row)}")
        rows.append(row)
    return rows


# -- phase 3c, continued: each fp32 GEMM stage of the path at batch 16 ------------------------
#
# fp32 is what `fame` and every baseline run unless --bf16 is given, at the
# pipelines' batch 16: each fp32 product of the lab path at B 16 x S 560
# (R_BASE rows) through ``_build.gemm`` (csrc/gemm.cu::gemm_f32_nt_kernel for
# "nt", gemm_f32_nn_tn_kernel for "nn") or ``fused_attention_block.weight_grad``
# (gemm_f32_nn_tn_kernel's split-K "tn" and the fixed-order sum), with the
# epilogue the path gives it, against the same product and epilogue in
# float64 on the card, each row with its persistent schedule.  Limit
# F32_GEMM_TOL of the output's max-abs (and of the column sums', the aux's):
# fp32 sums of up to 4480 terms per chain stay near 1e-6 of it, while TF32
# (10-bit mantissas) misses it by 10x or more, so the check also holds the
# kernel to IEEE fp32.  Every "nn" and "tn" stage run twice must leave the
# same bits (and column sums).  Timed beside one ``F.linear`` /
# ``torch.matmul`` in fp32 with TF32 off (cuBLAS; a yardstick the port never
# calls), each with its TFLOP/s and its bound at the CUDA cores' 67 TFLOP/s.

F32_GEMM_TOL = 1e-5
R_BASE = 16 * 560
# name, layout, M, N, K, activation (nt) or gate (nn), inner dropout rate (nt)
# or fp32 residual (nn), aux, timed
F32_GEMM_STAGES = (
    ("qkv", "nt", R_BASE, 2304, 768, "none", 0.0, False, True),
    ("wo", "nt", R_BASE, 768, 768, "none", 0.0, False, True),
    ("w1 relu dropout aux", "nt", R_BASE, 2048, 768, "relu", 0.1, True, True),
    ("w2", "nt", R_BASE, 768, 2048, "none", 0.0, False, True),
    ("dO attention", "nn", R_BASE, 768, 768, None, False, False, True),
    ("dx attention + resid", "nn", R_BASE, 768, 2304, None, True, False, True),
    ("dh ffn relu gate + colpart", "nn", R_BASE, 2048, 768, "relu", False, False, True),
    ("dx ffn + resid", "nn", R_BASE, 768, 2048, None, True, False, True),
    ("dWo split-K", "tn", 768, 768, R_BASE, None, False, False, True),
    ("dWqkv split-K", "tn", 2304, 768, R_BASE, None, False, False, True),
    ("dW1 split-K", "tn", 2048, 768, R_BASE, None, False, False, True),
    ("dW2 split-K", "tn", 768, 2048, R_BASE, None, False, False, True),
    ("text w1 gelu aux", "nt", 8 * 512, 3072, 768, "gelu", 0.0, True, True),
    ("text w2", "nt", 8 * 512, 768, 3072, "none", 0.0, False, True),
    ("text dh dgelu gate + aux", "nn", 8 * 512, 3072, 768, "dgelu", False, True, False),
    ("ragged nt M600 N200 K96 relu dropout", "nt", 600, 200, 96, "relu", 0.1, True, False),
    ("ragged nn M600 N200 K96 relu gate", "nn", 600, 200, 96, "relu", False, False, False),
    ("ragged tn M600 N200 K5000", "tn", 600, 200, 5000, None, False, False, False),
    ("lab dWqkv split-K", "tn", 2304, 768, R_LAB, None, False, False, False),
)


def f32_gemm_check(_build, fab, gen, name, layout, M, N, K, act_or_gate, extra, with_aux,
                   timed, bias_shift=0.0):
    from fairmultimodal_torch.utils import rng

    f32, f64 = torch.float32, torch.float64
    a = torch.randn(*((K, M) if layout == "tn" else (M, K)), generator=gen, device="cuda")
    b = torch.randn(*((N, K) if layout == "nt" else (K, N)), generator=gen, device="cuda") \
        * K ** -0.5
    out = torch.empty(M, N, device="cuda")
    aux = torch.empty(M, N, device="cuda") if with_aux else None
    colpart = None
    if layout == "nt":
        bias = 0.02 * torch.randn(N, generator=gen, device="cuda") + bias_shift
        drop = _keyed(rng.Dropout.make(NT_SEED, 0, extra))
        run = lambda: _build.gemm(a, b, out, bias=bias, activation=act_or_gate,  # noqa: E731
                                  dropout=drop, aux=aux)
        (want, want_aux), want_sum = _nt_plain(a, b, bias, act_or_gate, drop, f64,
                                               compute=f64), None
        lib = lambda: torch.nn.functional.linear(a, b, bias)  # noqa: E731
    elif layout == "nn":
        gate = torch.randn(M, N, generator=gen, device="cuda") if act_or_gate else None
        resid = torch.randn(M, N, generator=gen, device="cuda") if extra else None
        colpart = torch.empty(-(-M // 128), N, device="cuda") if act_or_gate else None
        run = lambda: _build.gemm(  # noqa: E731
            a, b, out, layout="nn", gate=gate, gate_kind=act_or_gate,
            gate_scale=GATE_SCALE if act_or_gate == "relu" else 1.0, aux=aux, resid=resid,
            colpart=colpart)
        lib = lambda: torch.matmul(a, b)  # noqa: E731
    else:
        gate = resid = None
        run = lambda: fab.weight_grad(a, b, out)  # noqa: E731
        lib = lambda: torch.matmul(a.t(), b)  # noqa: E731
    if layout != "nt":
        want, want_aux, want_sum = _nn_tn_plain(layout, a, b, gate, act_or_gate, resid, f64,
                                                compute=f64)
    run()
    torch.cuda.synchronize()
    row = {"stage": name, "layout": layout, "M": M, "N": N, "K": K,
           "epilogue": act_or_gate, "errors": _rel_errors(out.double(), want)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row["tile"] = _build.sgemm_tile(layout, M, N, 1, sms)
    # The persistent launch: grid, units (tiles x splits), on the busiest SM / consumer.
    if layout == "nt":
        row["schedule"] = _build.sgemm_nt_schedule(M, N, sms)
    else:
        row["splits"] = fab._splits(M, N, K, sms, f32) if layout == "tn" else 1
        row["schedule"] = _build.sgemm_nn_tn_schedule(M, N, row["splits"], sms)
    if layout == "tn":
        row["rows_per_split"] = _build.split_rows(K, row["splits"], f32)
    checks = [("out", row["errors"])]
    if with_aux:
        row["aux_errors"] = _rel_errors(aux.double(), want_aux)
        checks.append(("aux", row["aux_errors"]))
    if colpart is not None:
        row["colsum_errors"] = _rel_errors(colpart.double().sum(dim=0), want_sum)
        checks.append(("column sums", row["colsum_errors"]))
    if layout != "nt":   # the persistent schedule and split-K sums: the same bits twice
        first = (out.clone(), None if colpart is None else colpart.clone())
        run()
        row["deterministic"] = torch.equal(first[0], out) and (
            colpart is None or torch.equal(first[1], colpart))
        if not row["deterministic"]:
            raise AssertionError(f"fp32 {layout} gemm {name}: two runs differ")
        del first
    for what, e in checks:
        if not torch.isfinite(out).all() or e["max_abs_err"] > F32_GEMM_TOL * e["max_abs"]:
            raise AssertionError(f"fp32 {layout} gemm {name}: {what} {e} (limit {F32_GEMM_TOL} "
                                 "of max-abs against float64)")
    if bias_shift:   # as nt_gemm_check's bf16 row: no pre-activation near zero
        kept = out != 0
        row["zeroed_as_plain"] = bool(torch.equal(kept, want != 0))
        row["kept_fraction"] = kept.float().mean().item()
        row["min_pre_activation"] = want_aux.min().item()
        if not row["min_pre_activation"] > 0 or not row["zeroed_as_plain"]:
            raise AssertionError(f"fp32 nt gemm {name}: dropout mask differs from the plain one "
                                 f"{row}")
        del kept
    del want, want_aux, want_sum
    if timed:
        flops = 2 * M * N * K
        row["ms"] = time_ms(run)
        row["tflops"] = flops / row["ms"] / 1e9
        row["library_ms"] = time_ms(lib)
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        extra_mn = int(with_aux) + int(layout == "nn" and bool(act_or_gate or extra))
        nbytes = (M * K + K * N + M * N * (1 + extra_mn)) * 4   # + aux out, gate / resid in
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, FP32_PEAK)
    del a, b, out, aux, colpart
    torch.cuda.empty_cache()
    return row


def f32_gemm_phase(_build, fab):
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for stage in F32_GEMM_STAGES:
        row = f32_gemm_check(_build, fab, gen, *stage)
        log(f"[f32-gemm] {json.dumps(row)}")
        rows.append(row)
    # The Philox mapping of the fp32 "nt" kernel, element for element (the
    # bf16 "bias +8" row of nt_gemm_phase, in fp32).
    row = f32_gemm_check(_build, fab, gen, "w1 relu dropout aux, bias +8", "nt", R_BASE, 2048,
                         768, "relu", 0.1, True, False, bias_shift=8.0)
    log(f"[f32-gemm] {json.dumps(row)}")
    rows.append(row)
    return rows


#: The kernels redesigned for Hopper (the bf16 path's, the fp32 GEMMs and the
#: fp32 flash forward and backward), whose ``-Xptxas -v`` lines phase 2 reports.
PTXAS_KERNELS = ("gemm_bf16_nt_kernel", "gemm_bf16_nn_tn_kernel", "flash_attn_fwd_wgmma_kernel",
                 "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
                 "gemm_f32_nt_kernel", "gemm_f32_nn_tn_kernel", "flash_attn_fwd_f32_kernel",
                 "flash_bwd_rowterm_f32_kernel", "flash_bwd_dq_f32_kernel",
                 "flash_bwd_dkdv_f32_kernel", "layernorm_bwd_kernel", "colsum_kernel")
#: Kernels that must not spill (their accumulators live in registers).
NO_SPILL_KERNELS = ("gemm_bf16_nt_kernel", "gemm_bf16_nn_tn_kernel", "gemm_f32_nt_kernel",
                    "gemm_f32_nn_tn_kernel",
                    "flash_attn_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                    "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_f32_kernel",
                    "layernorm_bwd_kernel")


def ptxas_report(_build, names=PTXAS_KERNELS):
    """What ``nvcc -Xptxas -v`` said of each instantiation of ``names``
    (the build's logs): registers, stack, spills, and any warning about
    them.  Raises if a name has no kernel in the logs, or if a kernel of
    ``NO_SPILL_KERNELS`` spills."""
    import re

    report = {}
    for lib in _build.build().values():
        current = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?",
                          line)
            if m:
                current = m.group(1) if any(n in m.group(1) for n in names) else None
                if current:
                    report.setdefault(current, {})
                continue
            if "warning" in line and any(n in line for n in names + ("setmaxnreg",)):
                report.setdefault("warnings", []).append(line.strip())
            if current is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                       spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[current]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                report[current]["static_smem"] = int(m.group(1)) if m else 0
    missing = [n for n in names if not any(n in k for k in report)]
    if missing:
        raise AssertionError(f"ptxas report: no kernel named {missing} in the build logs")
    for name, row in report.items():
        if any(n in name for n in NO_SPILL_KERNELS) and (
                row.get("spill_stores", 1) or row.get("spill_loads", 1)):
            raise AssertionError(f"ptxas report: {name} spills or has no spill line: {row}")
    return report


def ln_bwd_occupancy(_build, report, h=768):
    """Blocks an SM that ``layernorm_bwd_kernel`` can hold at H ``h``, by
    registers (the ptxas report of its NC = ceil(h / 256) instantiations)
    and by shared memory (its launch plan), for bf16 and fp32 io.  Raises
    below the plan's blocks an SM (two at H 768)."""
    nc = -(-h // 256)
    threads = _build.LN_BWD["threads"]
    out = {}
    for name, row in report.items():
        if "layernorm_bwd_kernel" not in name or f"Li{nc}E" not in name:
            continue
        regs = -(-row["registers"] // 8) * 8
        out[name[-60:]] = {"registers": row["registers"], "blocks_by_registers":
                           65536 // (regs * threads)}
    for dt in (torch.bfloat16, torch.float32):
        plan = _build.layernorm_bwd_plan(143360, h, dt, 132)
        out[str(dt)] = {"smem": plan["smem"], "blocks_by_plan": plan["blocks_per_sm"]}
    want = _build.LN_BWD["min_blocks"][nc]
    low = {k: v for k, v in out.items() if min(v.get("blocks_by_registers", want),
                                               v.get("blocks_by_plan", want)) < want}
    if len(out) < 3 or low:
        raise AssertionError(f"layernorm_bwd_kernel at H {h}: under {want} blocks an SM: {out}")
    return out


# -- phase 3d: the flash kernels (Pallas #9 / #10) against their plain versions -------------
#
# Limits, relative to each output's largest entry: fp32 FP32_FLASH_TOL for o,
# dq, dk, dv (only the summation order differs: the kernel's online softmax
# and tiled sums against the plain version's whole-row ones), and each of
# them also within FLASH_F64_TOL of the same function in float64 (phase 3c's
# rule for the fp32 GEMM stages: IEEE fp32 chains stay near 1e-6, TF32
# misses by 10x or more; a fully masked row as the fp32 kernels define it,
# the uniform softmax and its VJP).  bf16 forward
# FLASH_BF16_FWD (max) / TRAIN_BF16_MEAN (mean): the plain version (as the
# TPU kernel) rounds the normalised p to bf16 before p.v, the kernel the
# unnormalised exp(s - m_running) and divides o by the fp32 row sum once at
# the end; both round o to bf16.  The two differ by at most one bf16 rounding
# of each p (2^-8 relative) and of o; four ulps of margin
# (tests/test_torch_flash_forward_contract.py holds the kernel's order
# against the Pallas kernel on the CPU).  bf16 grads TRAIN_BF16_MAX /
# TRAIN_BF16_MEAN, phase 3b's: the
# kernel takes the softmax-VJP row term as rowsum(dO * O) from the stored
# bf16 o, the plain version (as the TPU kernel) rowsum(dP * P); equal for a
# normalised P, in bf16 they differ by about one rounding of the row term,
# and ds * scale and p are rounded to bf16 on both sides from sums taken in
# another order, so a rounding can flip by an ulp and carry into a product
# over S terms.
#
# The bf16 backward is also held against its own order of rounding repeated
# in PyTorch (flash_bwd_kernel_order, on the forward kernel's o and stats;
# tests/test_torch_flash_backward_contract.py holds that function against
# the Pallas kernel on the CPU).  Only fp32 summation orders differ there, so
# an entry may differ by the flip of its final rounding, plus the rare flip
# of a rounded p or ds * scale carried into a sum over S terms; such a flip
# moves a term by 2^-8 of itself, and a large p makes that a visible share of
# an entry near zero.  On the H100 0.03-0.13% of the entries differ, the
# most by one bf16 ulp of an entry near max-abs (at most 3.3e-3 of it).
# Limits: at most FLASH_BWD_ORDER_SHARE of the entries differ at all, and
# each by at most NT_BF16_MAX (one bf16 ulp) of max-abs.  A drift of the
# order shows in the share: D from the unrounded o changes about 18% of dq
# and dk, a p left unrounded before dv 42% of dv.

FP32_FLASH_TOL = 1e-4
FLASH_F64_TOL = 1e-5
FLASH_BF16_FWD = 2.0 ** -6
FLASH_GRADS = ("dq", "dk", "dv")
FLASH_BWD_ORDER_SHARE = 0.01
LOG2E = 1.4426950408889634


def _flash_inputs(B, S, nh, d, layout, mask_kind, dtype, gen):
    """q, k, v as the callers lay them out, all leaves' views: "dense" --
    three [B, S, H] Dense outputs viewed as heads (the layer's); "packed" --
    one [B, S, 3H] buffer split as ``fused_qkv`` splits it; "contiguous" --
    [B, heads, S, d] tensors.  Returns (leaves, q, k, v, mask, g)."""
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    H = nh * d
    if layout == "dense":
        leaves = [rn(B, S, H).requires_grad_(True) for _ in range(3)]
        q, k, v = (t.view(B, S, nh, d).transpose(1, 2) for t in leaves)
    elif layout == "packed":
        leaves = [rn(B, S, 3 * H).requires_grad_(True)]
        q, k, v = (t.transpose(1, 2) for t in leaves[0].view(B, S, 3, nh, d).unbind(2))
    else:
        leaves = [rn(B, nh, S, d).requires_grad_(True) for _ in range(3)]
        q, k, v = leaves
    if mask_kind == "lab":       # 549 real lab tokens padded to 560, as BEHRTLab expands it
        mask = (torch.arange(S, device="cuda") < N_LABS).int()[None].expand(B, S)
    elif mask_kind == "rows":    # per-row lengths, the last row fully masked
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
        lens[-1] = 0
        mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).int()
    else:
        mask = None
    return leaves, q, k, v, mask, rn(B, nh, S, d)


def flash_check(flash, gen, dtype, B, S, nh, d, layout="dense", mask_kind="rows", timed=False,
                peak=BF16_PEAK, stages=True):
    """#9 and #10 through ``flash_attention`` and its op's autograd
    against ``flash_attention_reference`` and
    ``flash_attention_backward_reference`` on the same inputs."""
    leaves, q, k, v, mask, g = _flash_inputs(B, S, nh, d, layout, mask_kind, dtype, gen)
    label = f"flash B{B} S{S} {nh}x{d} {layout} mask {mask_kind} {dtype}"
    out = flash.flash_attention(q, k, v, mask)
    grads = torch.autograd.grad(out, (q, k, v), g)
    with torch.no_grad():
        qd, kd, vd = (t.detach() for t in (q, k, v))
        want = flash.flash_attention_reference(qd, kd, vd, mask)
        want_grads = flash.flash_attention_backward_reference(qd, kd, vd, mask, g)
    got = {"o": out.detach(), **dict(zip(FLASH_GRADS, grads))}
    ref = {"o": want, **dict(zip(FLASH_GRADS, want_grads))}
    rows = {}
    for name, w in ref.items():
        a, b_ = got[name].float(), w.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {name} not finite")
        err = (a - b_).abs()
        scale = max(b_.abs().max().item(), 1e-30)
        mx, mean = err.max().item(), err.mean().item()
        rows[name] = {"max_abs_err": mx, "mean_abs_err": mean, "max_abs": scale}
        if dtype == torch.float32:
            ok = mx <= FP32_FLASH_TOL * scale
        else:
            lim = FLASH_BF16_FWD if name == "o" else TRAIN_BF16_MAX
            ok = mx <= lim * scale and mean <= TRAIN_BF16_MEAN * scale
        if not ok:
            raise AssertionError(f"{label}: {name} max {mx} mean {mean} (max-abs {scale})")
    row = {"case": label, "errors": rows}
    if dtype == torch.float32:
        rows["o_vs_f64"] = _flash_f64_errors(flash, label, got["o"], qd, kd, vd, mask)
        rows.update(_flash_bwd_f64_errors(label, grads, qd, kd, vd, mask, g))
        row["rows_per_block"] = flash._build.flash_fwd_f32_rows(S)
    del out, grads, got, want_grads
    with torch.no_grad():
        ops = flash._operands(qd, kd, vd, mask)
        o, stats = flash._forward_kernel(*ops, residuals=True)
        saved = (*ops[:3], o, stats, ops[3])
        if dtype == torch.bfloat16:
            row["kernel_order"] = _flash_bwd_order_check(flash, label, saved, g)
        elif not timed:    # every fp32 backward runs twice (the timed one below)
            first = flash._backward_kernel(*saved, g)
            again = flash._backward_kernel(*saved, g)
            row["bwd_deterministic"] = all(torch.equal(a, b_) for a, b_ in zip(first, again))
            if not row["bwd_deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            del first, again
    if timed:
        F = torch.nn.functional
        with torch.no_grad():
            row["ms"] = time_ms(lambda: flash.flash_attention(qd, kd, vd, mask))
            row["fwd_res_ms"] = time_ms(lambda: flash._forward_kernel(*ops, residuals=True))
            row["bwd_ms"] = time_ms(lambda: flash._backward_kernel(*saved, g))
            if stages:    # the dQ and dK / dV kernels apart, from the profiler
                row["bwd_stages_ms"] = _flash_bwd_stages_ms(flash, saved, g)
            first = flash._backward_kernel(*saved, g)
            again = flash._backward_kernel(*saved, g)
            row["bwd_deterministic"] = all(torch.equal(a, b_) for a, b_ in zip(first, again))
            if not row["bwd_deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            del first, again
            row["plain_ms"] = time_ms(lambda: flash.flash_attention_reference(qd, kd, vd, mask),
                                      reps=5)
            row["plain_bwd_ms"] = time_ms(lambda: flash.flash_attention_backward_reference(
                qd, kd, vd, mask, g), reps=3)
            bias = None if mask is None else \
                torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=bias))
            row["library_kernels"] = device_kernels(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=bias))
        lib = [t.detach().clone().requires_grad_(True) for t in (qd, kd, vd)]
        row["library_bwd_ms"] = _time_backward(
            F.scaled_dot_product_attention(*lib, attn_mask=bias), lib, g)
        e = qd.element_size()
        mask_bytes = 0 if mask is None else B * S * 4
        flops, nbytes = 4 * B * nh * S * S * d, 4 * B * nh * S * d * e + mask_bytes
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, peak)
        flops_b, nbytes_b = 10 * B * nh * S * S * d, 7 * B * nh * S * d * e + mask_bytes
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(flops_b, nbytes_b, peak)
        row["flops"], row["bytes"], row["bwd_flops"], row["bwd_bytes"] = \
            flops, nbytes, flops_b, nbytes_b
        del lib
    del leaves, q, k, v, qd, kd, vd, want, g, ops, o, stats, saved
    torch.cuda.empty_cache()
    return row


def _flash_f64_errors(flash, label, o, q, k, v, mask):
    """The fp32 forward's o against the same function in float64 on the same
    inputs, within FLASH_F64_TOL of max-abs (IEEE fp32; TF32 misses it).  A
    fully masked row is held to the mean of v: in fp32 s * scale - 1e9
    rounds to -1e9 for every key (one ulp there is 64), the uniform softmax
    the TPU kernels give, which float64 would resolve."""
    with torch.no_grad():
        want = flash.flash_attention_reference(q.double(), k.double(), v.double(), mask)
        if mask is not None:
            dead = ~(mask > 0).any(dim=1)
            want[dead] = v.double()[dead].mean(dim=2, keepdim=True).expand_as(want[dead])
        err = (o.double() - want).abs().max().item()
        scale = want.abs().max().item()
    if not err <= FLASH_F64_TOL * scale:
        raise AssertionError(f"{label}: o misses float64 by {err} (max-abs {scale}, limit "
                             f"{FLASH_F64_TOL} of it)")
    return {"max_abs_err": err, "max_abs": scale}


def flash_bwd_f64(q, k, v, mask, g):
    """(dq, dk, dv) of the flash attention in float64 from q, k, v, g [B,
    heads, S, d] and mask [B, S] (or None), with the fp32 kernels' meaning of
    a fully masked row: the uniform softmax (see :func:`_flash_f64_errors`)
    and its VJP, ds = p * (dp - rowsum(dO * o)) * scale."""
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    x = (qd @ kd.transpose(-1, -2)) * scale
    if mask is not None:
        x = x + torch.where(mask > 0, 0.0, -1e9).double()[:, None, None, :]
        x[~(mask > 0).any(dim=1)] = 0.0
    p = torch.softmax(x, dim=-1)
    del x
    o = p @ vd
    dv = p.transpose(-1, -2) @ gd
    ds = p * (gd @ vd.transpose(-1, -2) - (gd * o).sum(-1, keepdim=True)) * scale
    del p
    return ds @ kd, ds.transpose(-1, -2) @ qd, dv


def _flash_bwd_f64_errors(label, grads, q, k, v, mask, g, rows=32):
    """The fp32 backward's dq, dk, dv against :func:`flash_bwd_f64` on the
    same inputs (``rows`` batch rows at a time), each within FLASH_F64_TOL of
    its max-abs (phase 3c's float64 rule for the fp32 GEMM stages): the
    errors as ``{"dq_vs_f64": {"max_abs_err", "max_abs"}, ...}``."""
    errs = {n: [0.0, 0.0] for n in FLASH_GRADS}
    with torch.no_grad():
        for b0 in range(0, q.shape[0], rows):
            part = slice(b0, b0 + rows)
            want = flash_bwd_f64(q[part], k[part], v[part],
                                 None if mask is None else mask[part], g[part])
            for name, a, w in zip(FLASH_GRADS, grads, want):
                e = errs[name]
                e[0] = max(e[0], (a[part].double() - w).abs().max().item())
                e[1] = max(e[1], w.abs().max().item())
            del want
    out = {}
    for name, (err, scale) in errs.items():
        out[f"{name}_vs_f64"] = {"max_abs_err": err, "max_abs": scale}
        if not err <= FLASH_F64_TOL * scale:
            raise AssertionError(f"{label}: {name} misses float64 by {err} (max-abs {scale}, "
                                 f"limit {FLASH_F64_TOL} of it)")
    return out


def device_kernels(fn, reps=3):
    """The CUDA kernels ``fn()`` launches, by name, with their device time
    per call (torch.profiler over ``reps`` calls after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}


def flash_bwd_kernel_order(q, k, v, o, stats, mask, g):
    """dq, dk, dv of the bf16 backward kernels in their order of rounding,
    in PyTorch, from the forward kernel's bf16 o and its stats (m, l):
    D = rowsum(dO * o); p = exp2((s * scale + bias - m) * log2 e) * (1 / l);
    dv = round(p)^T . dO; round(p * (dO . v^T - D) * scale) before dq = . k
    and dk = ^T . q; each grad rounded when written."""
    bf = torch.bfloat16
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    m, l = stats[..., 0:1], stats[..., 1:2]
    D = (gf * o.float()).sum(-1, keepdim=True)
    x = (qf @ kf.transpose(-1, -2)) * scale
    if mask is not None:
        x = x + torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    p = torch.exp2((x - m) * LOG2E) * (1.0 / l)
    del x
    dv = (p.to(bf).float().transpose(-1, -2) @ gf).to(bf)
    ds = (p * (gf @ vf.transpose(-1, -2) - D) * scale).to(bf).float()
    del p
    return (ds @ kf).to(bf), (ds.transpose(-1, -2) @ qf).to(bf), dv


def _flash_bwd_order_check(flash, label, saved, g):
    """The bf16 backward kernels against :func:`flash_bwd_kernel_order` on
    the same forward residuals: the share of each grad's entries that differ
    (FLASH_BWD_ORDER_SHARE at most) and its largest difference relative to
    its max-abs (NT_BF16_MAX at most)."""
    got = flash._backward_kernel(*saved, g)
    q, k, v, o, stats, mask = saved
    want = flash_bwd_kernel_order(q, k, v, o, stats, mask, g)
    res = {}
    for name, a, w in zip(FLASH_GRADS, got, want):
        a, w = a.float(), w.float()
        rel = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        share = (a != w).float().mean().item()
        res[name] = {"max_rel_err": rel, "differ_share": share}
        if not (rel <= NT_BF16_MAX and share <= FLASH_BWD_ORDER_SHARE):
            raise AssertionError(f"{label}: {name} differs from the kernel's rounding order "
                                 f"by {rel} of max-abs in {share} of the entries (limits "
                                 f"{NT_BF16_MAX}, {FLASH_BWD_ORDER_SHARE})")
    del got, want
    return res


def _flash_bwd_stages_ms(flash, saved, g, reps=10):
    """The flash backward's kernels timed apart: device time per call of the
    dQ and dK / dV kernels and, in fp32, of the pass that writes the row term
    D first (bf16's dQ kernel writes it), from the profiler over ``reps``
    backward calls on the forward's residuals."""
    kernels = device_kernels(lambda: flash._backward_kernel(*saved, g), reps)
    names = ("flash_bwd_rowterm", "flash_bwd_dq", "flash_bwd_dkdv")
    ms = {name: sum(t for key, t in kernels.items() if name in key) for name in names}
    fp32 = saved[0].dtype == torch.float32
    if not all(ms[n] for n in names[0 if fp32 else 1:]):
        raise AssertionError(f"flash backward stages: the profiler saw {ms}")
    if not fp32:
        del ms["flash_bwd_rowterm"]
    return ms


def fused_qkv_layer_check(gen, B=16, S=560, H=768, nh=8):
    """``TorchEncoderLayer(fused_qkv=True)`` against the same layer unfused,
    the qkv weight concatenated from query / key / value, fp32, train mode
    with dropout on (one generator seed): forward and every grad within
    FP32_FLASH_TOL of its max-abs."""
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer
    from fairmultimodal_torch.utils.rng import make_generator

    unfused = init_params(TorchEncoderLayer(H, nh, attn_kernel=False), seed=7).cuda().train()
    fused = TorchEncoderLayer(H, nh, fused_qkv=True).cuda().train()
    sd = {k: v for k, v in unfused.state_dict().items()
          if k.split(".")[0] not in ("query", "key", "value")}
    for leaf in ("weight", "bias"):
        sd[f"qkv.{leaf}"] = torch.cat([unfused.state_dict()[f"{n}.{leaf}"]
                                       for n in ("query", "key", "value")])
    fused.load_state_dict(sd, strict=True)
    x = torch.randn(B, S, H, generator=gen, device="cuda")
    mask = (torch.arange(S, device="cuda") < N_LABS).int()[None].expand(B, S)
    g = torch.randn(B, S, H, generator=gen, device="cuda")
    runs = {}
    for name, layer in (("unfused", unfused), ("fused", fused)):
        xx = x.clone().requires_grad_(True)
        out = layer(xx, mask, make_generator(3))
        out.backward(g)
        grads = {n: p.grad for n, p in layer.named_parameters()}
        if name == "fused":
            for leaf in ("weight", "bias"):
                for n, part in zip(("query", "key", "value"), grads.pop(f"qkv.{leaf}").chunk(3)):
                    grads[f"{n}.{leaf}"] = part
        runs[name] = {"out": out.detach(), "x": xx.grad, **grads}
    errs = {}
    for n, w in runs["unfused"].items():
        scale = w.abs().max().item()
        if n == "key.bias":        # zero in exact arithmetic: rounding noise only
            scale = runs["unfused"]["query.bias"].abs().max().item()
        err = (runs["fused"][n] - w).abs().max().item()
        errs[n] = err / scale
        if not err <= FP32_FLASH_TOL * scale:
            raise AssertionError(f"fused_qkv layer: {n} max abs err {err} (max-abs {scale})")
    worst = max(errs, key=errs.get)
    del unfused, fused, runs
    torch.cuda.empty_cache()
    return {"case": f"TorchEncoderLayer fused_qkv vs unfused B{B} S{S} {nh}x{H // nh} fp32",
            "worst": worst, "worst_rel_err": errs[worst]}


def flash_kernel_phase(flash):
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16, f32 = dtype == torch.bfloat16, dtype == torch.float32
        peak = BF16_PEAK if bf16 else FP32_PEAK
        for kw in (dict(B=256, S=560, nh=8, d=96, mask_kind="lab", timed=bf16),   # lab
                   dict(B=16, S=560, nh=8, d=96, mask_kind="lab", timed=f32),     # lab, batch 16
                   dict(B=16, S=560, nh=8, d=96, layout="packed", mask_kind="lab"),  # #1's
                   dict(B=32, S=512, nh=12, d=64, timed=f32),                      # text-train
                   dict(B=8, S=256, nh=8, d=32, mask_kind="none"),                 # off the path
                   dict(B=4, S=1024, nh=4, d=128, layout="contiguous"),
                   dict(B=8, S=384, nh=12, d=64, layout="packed"),
                   dict(B=4, S=200, nh=4, d=20)):                  # TMA-padded copies
            row = flash_check(flash, gen, dtype, peak=peak, stages=bf16, **kw)
            log(f"[flash-kernels] {json.dumps(row)}")
            rows.append(row)
    layer = fused_qkv_layer_check(gen)
    log(f"[flash-kernels] {json.dumps(layer)}")
    return rows, layer


# -- phase 4: the serving slice ------------------------------------------------------


def make_cohort(rng, n):
    words = ("patient stable intubated sedated ventilator weaning afebrile lungs clear "
             "bilateral infiltrates sepsis pressors lasix cardiac failure renal improving "
             "deteriorating family meeting comfort care extubated alert oriented pain "
             "controlled discharge planning").split()
    notes = []
    for i in range(n):
        if i % 10 == 9:
            notes.append([])                     # a patient without notes
            continue
        k = 1 + i % 3
        lens = [CHUNK_WORDS[(i + j) % 4] for j in range(k)]
        notes.append([" ".join(rng.choice(words, m)) for m in lens])
    return notes


def bundle_for(featurize, notes, rng):
    n = len(notes)
    return featurize.FeatureBundle(
        subject_id=np.arange(10_000, 10_000 + n, dtype=np.int64),
        age_codes=rng.integers(0, 4, n).astype(np.int32),
        gender_codes=rng.integers(0, 2, n).astype(np.int32),
        ethnicity_codes=rng.integers(0, 5, n).astype(np.int32),
        insurance_codes=rng.integers(0, 6, n).astype(np.int32),
        labs=rng.normal(0, 1, (n, N_LABS)).astype(np.float32),
        labels=np.zeros((n, 3), np.float32), lab_columns=[f"lab_{i}" for i in range(N_LABS)],
        note_chunks=notes)


def expected_text_launches(tokenizer, notes, batch_size, layers):
    """Text-encoder kernel launches per kernel: one per layer per batch of
    the 256 and 512 buckets (rows per batch as in encode_note_chunks)."""
    flat = [c for chunks in notes for c in chunks]
    _, mask = tokenizer.encode_batch(flat, max_length=512)
    buckets = np.searchsorted(np.asarray([64, 128, 256, 512]), mask.sum(axis=1))
    total = 0
    for b_i, b_len in ((2, 256), (3, 512)):
        rows = batch_size * min(8, max(1, 512 // b_len))
        total += -(-int((buckets == b_i).sum()) // rows)
    return total * layers


def slice_phase(fab, ffn):
    from fairmultimodal_torch.data import featurize
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.bert import bio_clinical_bert_config
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
    from fairmultimodal_torch.pipelines.common import build_arrays
    from fairmultimodal_torch.pipelines.fame import FAME_KEYS
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor

    bert_config = bio_clinical_bert_config()
    rng = np.random.default_rng(0)
    notes = make_cohort(rng, N_PATIENTS)
    bundle = bundle_for(featurize, notes, rng)
    geo = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6,
               lab_token_count=N_LABS, text_embed_size=768, hidden_size=768, demo_layers=12,
               demo_heads=12, lab_layers=2, lab_heads=8, fusion_hidden=512)
    t0 = time.perf_counter()
    model = init_params(FAMEModel(**geo, dtype=torch.bfloat16), seed=0)
    encoder = TextEncoder.from_pretrained(fallback_config=bert_config, dtype=torch.bfloat16,
                                          seed=1, device="cuda")
    predictor = FAMEPredictor(model, batch_size=256, device="cuda")
    log(f"[slice] models built in {time.perf_counter() - t0:.1f} s")

    # The main path, with the launch counters read around it.
    fab.launches = ffn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle.text_embeddings = encode_note_chunks(encoder, notes, max_length=512, batch_size=32)
    t_encode = time.perf_counter() - t0
    text = {"fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches}
    t0 = time.perf_counter()
    out = predictor.predict_arrays(build_arrays(bundle, FAME_KEYS))
    t_predict = time.perf_counter() - t0
    total = {"fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches}
    lab = {k: total[k] - text[k] for k in total}
    log(f"[slice] encode {len(notes)} patients {t_encode:.3f} s, predict {t_predict:.3f} s "
        f"(host clock, first call); launches text {text} lab {lab}")

    want_text = expected_text_launches(encoder.tokenizer, notes, 32, bert_config.num_hidden_layers)
    want_lab = geo["lab_layers"] * -(-N_PATIENTS // 256)
    for k in total:
        if text[k] != want_text or want_text == 0:
            raise AssertionError(f"{k}: {text[k]} text-encoder launches, expected {want_text}")
        if lab[k] != want_lab:
            raise AssertionError(f"{k}: {lab[k]} lab-encoder launches, expected {want_lab}")
    emb = bundle.text_embeddings
    no_notes = np.asarray([not c for c in notes])
    if emb.shape != (N_PATIENTS, 768) or not np.isfinite(emb).all():
        raise AssertionError(f"text embeddings {emb.shape} not finite")
    if emb[no_notes].any() or not np.abs(emb[~no_notes]).sum(axis=1).all():
        raise AssertionError("text embeddings: zero rows must be exactly the note-less patients")
    probs = out["probs"]
    if probs.shape != (N_PATIENTS, 3) or not np.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1:
        raise AssertionError(f"probabilities {probs.shape} not finite in [0, 1]")
    if not set(np.unique(out["preds"])) <= {0, 1}:
        raise AssertionError("predictions are not 0/1")

    # fp32 on 8 patients with long notes: kernels on the card vs plain on the CPU.
    pick = [i for i, c in enumerate(notes) if len(c) == 3][:8]
    sub_notes = [notes[i] for i in pick]
    sub = bundle_for(featurize, sub_notes, np.random.default_rng(1))
    probs_by_device = {}
    for device in ("cuda", "cpu"):
        m32 = init_params(FAMEModel(**geo, dtype=torch.float32), seed=0)
        enc32 = TextEncoder.from_pretrained(fallback_config=bert_config, seed=1, device=device)
        fab.launches = ffn.launches = 0
        sub.text_embeddings = encode_note_chunks(enc32, sub_notes, max_length=512, batch_size=2)
        pred32 = FAMEPredictor(m32, batch_size=8, device=device)
        probs_by_device[device] = pred32.predict_arrays(build_arrays(sub, FAME_KEYS))["probs"]
        counts = (fab.launches, ffn.launches)
        if (device == "cuda") != (min(counts) > 0) or (device == "cpu" and max(counts)):
            raise AssertionError(f"{device}: kernel launches {counts}")
        del m32, enc32, pred32
    diff = float(np.abs(probs_by_device["cuda"] - probs_by_device["cpu"]).max())
    log(f"[slice] fp32 8 patients: max |p_cuda - p_cpu| = {diff:.3e}")
    if not diff <= 1e-4:
        raise AssertionError(f"fp32 card vs CPU probabilities differ by {diff}")

    bench = predictor.benchmark(iters=20)
    log(f"[slice] FAMEPredictor.benchmark bf16: {json.dumps(bench)}")
    return total, {"text": text, "lab": lab, "encode_s": t_encode, "predict_s": t_predict,
                   "fp32_card_vs_cpu_max_abs": diff, "benchmark": bench}


# -- phase 5: the training slice -----------------------------------------------------


def synthetic_cohort(rng, n):
    """Model-input arrays and labels of ``n`` synthetic patients at the
    reference geometry (549 labs, 768-d note embeddings)."""
    return {
        "demo_dummy_ids": np.zeros((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, 4, n).astype(np.int32),
        "gender_ids": rng.integers(0, 2, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
        "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, N_LABS)).astype(np.float32),
        "text_embedding": rng.normal(0, 1, (n, 768)).astype(np.float32),
        "labels": rng.integers(0, 2, (n, 3)).astype(np.float32),
    }


TRAIN_GEO = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6,
                 lab_token_count=N_LABS, text_embed_size=768, hidden_size=768, demo_layers=12,
                 demo_heads=12, lab_layers=2, lab_heads=8, fusion_hidden=512)
POS_WEIGHT = np.array([3.0, 1.5, 2.0], np.float32)
N_TRAIN, N_VAL, TRAIN_BATCH, TRAIN_EPOCHS = 1024, 256, 256, 2
# fp32 card vs CPU: the same weights, batch and Philox masks; the card sums
# in other orders (its kernels, cuBLAS-free) than the CPU's plain path, so
# the loss agrees to fp32 rounding (1e-5 relative) and each grad leaf to
# 1e-3 of its largest entry (grads are differences of nearly equal sums).
XDEV_LOSS_TOL, XDEV_GRAD_TOL = 1e-5, 1e-3
#: fp32 one-step results (loss, grads) by configuration, shared by phases 5 and 5b.
FP32_STEPS = {}


def fp32_step_batch(train, keys, n=8):
    sub = {k: v[:n] for k, v in train.items()}
    return {"model_inputs": {k: sub[k] for k in keys}, "labels": sub["labels"],
            "weight": np.ones(n, np.float32)}


def set_fold(model, fold):
    """Set ``fold_ln`` on every encoder layer of ``model`` (None: read
    ``FMTPU_FOLD_LN``)."""
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer

    for layer in model.modules():
        if isinstance(layer, TorchEncoderLayer):
            layer.fold_ln = fold
    return model


def set_flash(model, flash=True):
    """Send every encoder layer of ``model`` down the flash route
    (``attn_kernel=False``: projections, Pallas #9 / #10, dropout + residual
    + LayerNorm), or back to the gates (``flash=False``)."""
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer

    for layer in model.modules():
        if isinstance(layer, TorchEncoderLayer):
            layer.attn_kernel = False if flash else None
    return model


def fp32_train_step(batch, device, fold=None, flash=False):
    """One fp32 ``FAMETrainer.train_step`` with dropout on, at full width,
    from seed-0 weights and generator seed 5: (loss, grads on the host)."""
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    m32 = set_flash(set_fold(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0),
                             fold), flash)
    t32 = FAMETrainer(m32, TrainConfig(lr=1e-4, batch_size=8), pos_weight=POS_WEIGHT,
                      rngs_seed=5, device=device)
    total, _ = t32.train_step(to_device(batch, t32.device))
    return float(total), {n: p.grad.detach().cpu() for n, p in m32.named_parameters()
                          if p.grad is not None}


def grad_errors(grads_c, grads_h):
    """Per leaf, the max error of ``grads_c`` against ``grads_h`` over the
    max-abs of ``grads_h`` (leaves with a zero grad left out)."""
    if set(grads_c) != set(grads_h):
        raise AssertionError(f"grad leaves differ: {set(grads_c) ^ set(grads_h)}")

    def scale(name):
        # A key bias has a zero grad in exact arithmetic (softmax ignores
        # it): measure its rounding noise on the q/k/v bias grads' scale.
        if name.endswith("key.bias"):
            return max(float(grads_h[name.replace("key", k)].abs().max())
                       for k in ("query", "key", "value"))
        return float(grads_h[name].abs().max())

    return {n: float((grads_c[n].double() - g.double()).abs().max()) / scale(n)
            for n, g in grads_h.items() if scale(n) > 0}


def compare_steps(got, want):
    """(loss rel, worst leaf, its max error over its max-abs) of two
    :func:`fp32_train_step` results."""
    (loss_c, grads_c), (loss_h, grads_h) = got, want
    rel = grad_errors(grads_c, grads_h)
    worst = max(rel, key=rel.get)
    return abs(loss_c - loss_h) / abs(loss_h), worst, rel[worst]


def train_slice_phase(fab, ffn):
    from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    rng = np.random.default_rng(2)
    train, val = synthetic_cohort(rng, N_TRAIN), synthetic_cohort(rng, N_VAL)
    keys = [k for k in train if k != "labels"]
    train_loader = NestedLoader(BatchIterator(train, TRAIN_BATCH, shuffle=True, seed=0), keys)
    val_loader = NestedLoader(BatchIterator(val, TRAIN_BATCH), keys)
    model = init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0)
    trainer = FAMETrainer(model, TrainConfig(lr=1e-4, num_epochs=TRAIN_EPOCHS,
                                             batch_size=TRAIN_BATCH),
                          pos_weight=POS_WEIGHT, rngs_seed=0, device="cuda")
    heads0 = {k: v.clone() for k, v in model.state_dict().items() if ".classifier_" in k}
    sig0 = model.fusion.sig_weights.detach().clone()

    # The main path, with the launch counters read around it.
    fab.launches = ffn.launches = fab.bwd_launches = ffn.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, history = trainer.fit(train_loader, val_loader, verbose=True)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = {"fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches,
              "fused_attention_block_ln_bwd": fab.bwd_launches,
              "fused_ffn_ln_bwd": ffn.bwd_launches}
    layers = TRAIN_GEO["lab_layers"]
    steps = TRAIN_EPOCHS * -(-N_TRAIN // TRAIN_BATCH)
    forwards = TRAIN_EPOCHS * (-(-N_TRAIN // TRAIN_BATCH) * 2 + -(-N_VAL // TRAIN_BATCH))
    want = {"fused_attention_block_ln": layers * forwards, "fused_ffn_ln": layers * forwards,
            "fused_attention_block_ln_bwd": layers * steps, "fused_ffn_ln_bwd": layers * steps}
    log(f"[train] fit {TRAIN_EPOCHS} epochs in {t_fit:.1f} s (host clock, first call); "
        f"launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    if len(history) != TRAIN_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"training history {history}")
    for k, v in heads0.items():
        if not torch.equal(model.state_dict()[k], v):
            raise AssertionError(f"loss-free head {k} moved")
    if torch.equal(model.fusion.sig_weights.detach(), sig0):
        raise AssertionError("sig_weights did not move")
    log(f"[train] history {json.dumps(history)}")
    log(f"[train] dynamic weights {json.dumps(trainer.dynamic_weights.tolist())}")

    # fp32, 8 patients, dropout on: one train step on the card and on the CPU.
    batch = fp32_step_batch(train, keys)
    for device in ("cuda", "cpu"):
        fab.bwd_launches = ffn.bwd_launches = 0
        FP32_STEPS[device] = fp32_train_step(batch, device)
        if (device == "cuda") != (min(fab.bwd_launches, ffn.bwd_launches) > 0):
            raise AssertionError(f"{device}: backward launches {fab.bwd_launches}, "
                                 f"{ffn.bwd_launches}")
    loss_rel, worst, grad_rel = compare_steps(FP32_STEPS["cuda"], FP32_STEPS["cpu"])
    log(f"[train] fp32 8 patients, one step card vs CPU: loss {FP32_STEPS['cuda'][0]:.8f} vs "
        f"{FP32_STEPS['cpu'][0]:.8f} (rel {loss_rel:.2e}); worst grad leaf {worst} "
        f"{grad_rel:.2e} of its max-abs")
    if not loss_rel <= XDEV_LOSS_TOL or not grad_rel <= XDEV_GRAD_TOL:
        raise AssertionError(f"fp32 card vs CPU: loss rel {loss_rel}, grads {grad_rel}")

    # Train-step time at batch 256, bf16, dropout on.
    batch = to_device(next(iter(train_loader)), trainer.device)
    bench = time_train_step(trainer, batch)
    log(f"[train] train step bf16: {json.dumps(bench)}")
    split = profile_train_step(trainer, batch)
    log(f"[train] train step split by kernel (profiler, per step): {json.dumps(split)}")
    return counts, {"step_split": split, "fit_s": t_fit, "history": history,
                    "dynamic_weights": trainer.dynamic_weights.tolist(),
                    "fp32_card_vs_cpu": {"loss_rel": loss_rel, "worst_grad_rel": grad_rel},
                    "train_step": bench}


def time_train_step(trainer, batch, steps=20, warmup=3):
    """Median CUDA-event time of ``trainer.train_step`` over ``steps``
    after ``warmup``."""
    for _ in range(warmup):
        trainer.train_step(batch)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    bs = len(batch["labels"])
    return {"batch_size": bs, "train_step_ms": ms, "patients_per_sec": 1e3 * bs / ms,
            "min_ms": min(times), "max_ms": max(times),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def profile_train_step(trainer, batch, steps=3, top=16):
    """Device time by kernel over ``steps`` train steps (torch.profiler's
    CUPTI trace), per step in ms, and the share of the host-clock window in
    which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy else None,
            "by_kernel_ms": {e.key[:90]: e.self_device_time_total / 1e3 / steps for e in rows},
            "launches_per_step": sum(e.count for e in kernels) / steps}


# -- phase 5b: the unfolded slice (FMTPU_FOLD_LN=0) ----------------------------------------

# fp32 unfolded vs folded on the card: the same weights, batch and Philox
# masks, and the same GEMM and flash kernels in the same order; only where
# the LayerNorm's residual cotangent is added to dx (inside the dx GEMM's
# epilogue or by autograd after it) and the glue's LayerNorm rows differ,
# so loss and grads agree to a few fp32 ulps.
FOLD_LOSS_TOL, FOLD_GRAD_TOL = 1e-6, 1e-4
N_FIT_TRAIN, N_FIT_VAL = 512, 256
PRED_FOLD_TOL = 1e-5


def _unfolded_counts(fab, ffn):
    return {"fused_attention_block": fab.unfolded_launches, "fused_ffn": ffn.unfolded_launches,
            "fused_attention_block_bwd": fab.unfolded_bwd_launches,
            "fused_ffn_bwd": ffn.unfolded_bwd_launches,
            "fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches,
            "fused_attention_block_ln_bwd": fab.bwd_launches, "fused_ffn_ln_bwd": ffn.bwd_launches}


def _all_counts(flash, fab, ffn, addnorm):
    """Every counted kernel's launches since the last reset."""
    counts = _unfolded_counts(fab, ffn)
    counts.update(glue=addnorm.launches, glue_bwd=addnorm.bwd_launches,
                  flash_attention=flash.launches, flash_attention_bwd=flash.bwd_launches)
    return counts


def _reset_counts(fab, ffn, addnorm):
    fab.launches = ffn.launches = fab.bwd_launches = ffn.bwd_launches = 0
    fab.unfolded_launches = ffn.unfolded_launches = 0
    fab.unfolded_bwd_launches = ffn.unfolded_bwd_launches = 0
    addnorm.launches = addnorm.bwd_launches = 0


def unfolded_slice_phase(fab, ffn, addnorm):
    import os

    from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    info = {}
    rng = np.random.default_rng(2)
    train, val = synthetic_cohort(rng, N_TRAIN), synthetic_cohort(rng, N_VAL)
    keys = [k for k in train if k != "labels"]

    # fp32 one step, dropout on: unfolded on the card vs folded on the card
    # (phase 5's run) and vs the plain path on the CPU (phase 5's run).
    _reset_counts(fab, ffn, addnorm)
    FP32_STEPS["cuda_unfolded"] = fp32_train_step(fp32_step_batch(train, keys), "cuda",
                                                  fold=False)
    counts = _unfolded_counts(fab, ffn)
    if min(list(counts.values())[:4]) == 0 or max(list(counts.values())[4:]) > 0:
        raise AssertionError(f"fp32 unfolded step: launches {counts}")
    for other, (loss_tol, grad_tol) in (("cuda", (FOLD_LOSS_TOL, FOLD_GRAD_TOL)),
                                        ("cpu", (XDEV_LOSS_TOL, XDEV_GRAD_TOL))):
        loss_rel, worst, grad_rel = compare_steps(FP32_STEPS["cuda_unfolded"], FP32_STEPS[other])
        info[f"fp32_unfolded_vs_{other}"] = {"loss_rel": loss_rel, "worst_leaf": worst,
                                             "worst_grad_rel": grad_rel}
        what = "folded card" if other == "cuda" else "CPU plain path"
        log(f"[unfolded] fp32 one step, unfolded card vs {what}: loss rel {loss_rel:.2e}, "
            f"worst grad leaf {worst} {grad_rel:.2e} of its max-abs")
        if not loss_rel <= loss_tol or not grad_rel <= grad_tol:
            raise AssertionError(f"fp32 unfolded vs {other}: loss rel {loss_rel}, "
                                 f"grads {grad_rel}")

    # The main path: FAMETrainer.fit, 1 epoch with validation, FMTPU_FOLD_LN=0.
    fit_train = {k: v[:N_FIT_TRAIN] for k, v in train.items()}
    train_loader = NestedLoader(BatchIterator(fit_train, TRAIN_BATCH, shuffle=True, seed=0),
                                keys)
    val_loader = NestedLoader(BatchIterator(val, TRAIN_BATCH), keys)
    model = init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0)
    trainer = FAMETrainer(model, TrainConfig(lr=1e-4, num_epochs=1, batch_size=TRAIN_BATCH),
                          pos_weight=POS_WEIGHT, rngs_seed=0, device="cuda")
    os.environ["FMTPU_FOLD_LN"] = "0"
    try:
        _reset_counts(fab, ffn, addnorm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, history = trainer.fit(train_loader, val_loader, verbose=True)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        counts = _unfolded_counts(fab, ffn)
        glue = {"forward": addnorm.launches, "backward": addnorm.bwd_launches}
    finally:
        del os.environ["FMTPU_FOLD_LN"]
    layers = TRAIN_GEO["lab_layers"]
    steps = -(-N_FIT_TRAIN // TRAIN_BATCH)
    forwards = steps * 2 + -(-N_VAL // TRAIN_BATCH)
    want = {"fused_attention_block": layers * forwards, "fused_ffn": layers * forwards,
            "fused_attention_block_bwd": layers * steps, "fused_ffn_bwd": layers * steps,
            "fused_attention_block_ln": 0, "fused_ffn_ln": 0,
            "fused_attention_block_ln_bwd": 0, "fused_ffn_ln_bwd": 0}
    want_glue = {"forward": 2 * layers * forwards, "backward": 2 * layers * steps}
    log(f"[unfolded] fit 1 epoch ({N_FIT_TRAIN} + {N_VAL} patients) in {t_fit:.1f} s "
        f"(host clock, first call); launches {counts}, expected {want}; glue {glue}")
    if counts != want or glue != want_glue:
        raise AssertionError(f"unfolded fit launches {counts} {glue}, expected {want} "
                             f"{want_glue}")
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    if len(history) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"unfolded training history {history}")
    info.update(fit_s=t_fit, fit_launches=counts, fit_glue_launches=glue, history=history)

    # bf16 train step at batch 256: folded and unfolded in turns, same call.
    batch = to_device(next(iter(train_loader)), trainer.device)
    steps_ms = {}
    for fold in (True, False, False, True):
        set_fold(model, fold)
        tag = "folded" if fold else "unfolded"
        steps_ms.setdefault(tag, []).append(time_train_step(trainer, batch))
    set_fold(model, False)
    split = profile_train_step(trainer, batch)
    info["train_step"] = steps_ms
    info["step_split"] = split
    log(f"[unfolded] train step bf16, folded / unfolded in turns: {json.dumps(steps_ms)}")
    log(f"[unfolded] unfolded train step split by kernel (profiler, per step): "
        f"{json.dumps(split)}")

    # Serving: fp32 probabilities unfolded vs folded, then the bf16 benchmark.
    arrays = {k: v[:64] for k, v in val.items() if k != "labels"}
    probs = {}
    for fold in (True, False):
        m32 = set_fold(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0), fold)
        probs[fold] = FAMEPredictor(m32, batch_size=64, device="cuda").predict_arrays(
            arrays)["probs"]
        del m32
    diff = float(np.abs(probs[True] - probs[False]).max())
    log(f"[unfolded] fp32 serving 64 patients: max |p_unfolded - p_folded| = {diff:.3e}")
    if not diff <= PRED_FOLD_TOL:
        raise AssertionError(f"fp32 unfolded vs folded probabilities differ by {diff}")
    serve = set_fold(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0), False)
    bench = FAMEPredictor(serve, batch_size=256, device="cuda").benchmark(iters=20)
    log(f"[unfolded] FAMEPredictor.benchmark bf16 unfolded: {json.dumps(bench)}")
    info.update(fp32_serving_unfolded_vs_folded=diff, benchmark=bench)
    del trainer, model, serve
    torch.cuda.empty_cache()
    return counts, info


# -- phase 5c: the flash-route slice (attn_kernel=False) ----------------------------------

# fp32 serving, flash route vs folded on the card: the same weights; the
# attention core runs the same flash forward (through other strides) and the
# projections, Wo and the LayerNorm take other kernels or PyTorch ops, so the
# probabilities agree to fp32 rounding.
PRED_FLASH_TOL = 1e-4


def _flash_counts(flash, fab, ffn, addnorm):
    return {"flash_attention": flash.launches, "flash_attention_bwd": flash.bwd_launches,
            "fused_ffn_ln": ffn.launches, "fused_ffn_ln_bwd": ffn.bwd_launches,
            "glue": addnorm.launches, "glue_bwd": addnorm.bwd_launches,
            "fused_attention_block_ln": fab.launches,
            "fused_attention_block_ln_bwd": fab.bwd_launches,
            "fused_attention_block": fab.unfolded_launches,
            "fused_attention_block_bwd": fab.unfolded_bwd_launches,
            "fused_ffn": ffn.unfolded_launches, "fused_ffn_bwd": ffn.unfolded_bwd_launches}


def flash_slice_phase(flash, fab, ffn, addnorm):
    from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    def reset():
        _reset_counts(fab, ffn, addnorm)
        flash.launches = flash.bwd_launches = 0

    info = {}
    rng = np.random.default_rng(2)
    train, val = synthetic_cohort(rng, N_TRAIN), synthetic_cohort(rng, N_VAL)
    keys = [k for k in train if k != "labels"]

    # fp32 one step, dropout on: the flash route on the card vs the folded
    # step on the card and the plain path on the CPU (phase 5's runs).
    reset()
    FP32_STEPS["cuda_flash"] = fp32_train_step(fp32_step_batch(train, keys), "cuda", flash=True)
    counts = _flash_counts(flash, fab, ffn, addnorm)
    if min(counts["flash_attention"], counts["flash_attention_bwd"]) == 0 or \
            counts["fused_attention_block_ln"] or counts["fused_attention_block"]:
        raise AssertionError(f"fp32 flash-route step: launches {counts}")
    for other in ("cuda", "cpu"):
        loss_rel, worst, grad_rel = compare_steps(FP32_STEPS["cuda_flash"], FP32_STEPS[other])
        info[f"fp32_flash_vs_{other}"] = {"loss_rel": loss_rel, "worst_leaf": worst,
                                          "worst_grad_rel": grad_rel}
        what = "folded card" if other == "cuda" else "CPU plain path"
        log(f"[flash] fp32 one step, flash route card vs {what}: loss rel {loss_rel:.2e}, "
            f"worst grad leaf {worst} {grad_rel:.2e} of its max-abs")
        if not loss_rel <= XDEV_LOSS_TOL or not grad_rel <= XDEV_GRAD_TOL:
            raise AssertionError(f"fp32 flash route vs {other}: loss rel {loss_rel}, "
                                 f"grads {grad_rel}")

    # The main path: FAMETrainer.fit, 1 epoch with validation, flash route.
    fit_train = {k: v[:N_FIT_TRAIN] for k, v in train.items()}
    train_loader = NestedLoader(BatchIterator(fit_train, TRAIN_BATCH, shuffle=True, seed=0),
                                keys)
    val_loader = NestedLoader(BatchIterator(val, TRAIN_BATCH), keys)
    model = set_flash(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0))
    trainer = FAMETrainer(model, TrainConfig(lr=1e-4, num_epochs=1, batch_size=TRAIN_BATCH),
                          pos_weight=POS_WEIGHT, rngs_seed=0, device="cuda")
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, history = trainer.fit(train_loader, val_loader, verbose=True)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = _flash_counts(flash, fab, ffn, addnorm)
    layers = TRAIN_GEO["lab_layers"]
    steps = -(-N_FIT_TRAIN // TRAIN_BATCH)
    forwards = steps * 2 + -(-N_VAL // TRAIN_BATCH)
    want = {k: 0 for k in counts}
    want.update(flash_attention=layers * forwards, flash_attention_bwd=layers * steps,
                fused_ffn_ln=layers * forwards, fused_ffn_ln_bwd=layers * steps,
                glue=layers * forwards, glue_bwd=layers * steps)
    log(f"[flash] fit 1 epoch ({N_FIT_TRAIN} + {N_VAL} patients) in {t_fit:.1f} s "
        f"(host clock, first call); launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"flash-route fit launches {counts}, expected {want}")
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    if len(history) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"flash-route training history {history}")
    info.update(fit_s=t_fit, fit_launches=counts, history=history)

    # bf16 train step at batch 256: folded and flash route in turns, same call.
    batch = to_device(next(iter(train_loader)), trainer.device)
    steps_ms = {}
    for on in (False, True, True, False):
        set_flash(model, on)
        steps_ms.setdefault("flash" if on else "folded", []).append(
            time_train_step(trainer, batch))
    set_flash(model)
    split = profile_train_step(trainer, batch)
    info["train_step"] = steps_ms
    info["step_split"] = split
    log(f"[flash] train step bf16, folded / flash route in turns: {json.dumps(steps_ms)}")
    log(f"[flash] flash-route train step split by kernel (profiler, per step): "
        f"{json.dumps(split)}")

    # Serving: fp32 probabilities flash route vs folded, then the bf16 benchmark.
    arrays = {k: v[:64] for k, v in val.items() if k != "labels"}
    probs = {}
    for on in (False, True):
        m32 = set_flash(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0), on)
        probs[on] = FAMEPredictor(m32, batch_size=64, device="cuda").predict_arrays(
            arrays)["probs"]
        del m32
    diff = float(np.abs(probs[True] - probs[False]).max())
    log(f"[flash] fp32 serving 64 patients: max |p_flash - p_folded| = {diff:.3e}")
    if not diff <= PRED_FLASH_TOL:
        raise AssertionError(f"fp32 flash route vs folded probabilities differ by {diff}")
    serve = set_flash(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0))
    bench = FAMEPredictor(serve, batch_size=256, device="cuda").benchmark(iters=20)
    log(f"[flash] FAMEPredictor.benchmark bf16 flash route: {json.dumps(bench)}")
    info.update(fp32_serving_flash_vs_folded=diff, benchmark=bench)
    del trainer, model, serve
    torch.cuda.empty_cache()
    return counts, info



# -- phase 6: the FAME experiment (run_fame_bundle) -----------------------------------

EXP_PATIENTS, EXP_EPOCHS, EXP_BATCH = 2048, 2, 256
EXP_PREVALENCE = (0.12, 0.25, 0.45)     # per task, so every split holds both classes
# The saved best_model npz reloaded by FAMEPredictor against the run's own
# test logits: the same bf16 kernels on the same rows and batches (row-
# independent), so equal up to the dynamic weights' rounding (float64 -> bf16
# in the trainer, float32 -> bf16 in the predictor).
EXP_NPZ_TOL = 1e-3
EXP_VECTOR_KEYS = {"gated_vectors": 3 * 256, "fusion_pre_relu_vectors": 512, "labels": 3,
                   "age": None, "ethnicity": None, "insurance": None, "logits": 3}


def experiment_bundle(featurize, rng, n=EXP_PATIENTS):
    """A seeded synthetic cohort as a FeatureBundle (no pandas): phase 4's
    notes and codes, labels drawn per task at ``EXP_PREVALENCE``."""
    notes = make_cohort(rng, n)
    bundle = bundle_for(featurize, notes, rng)
    bundle.labels = (rng.random((n, 3)) < np.asarray(EXP_PREVALENCE)).astype(np.float32)
    return bundle


def device_loader_check(arrays, labels, idx, seed):
    """One shuffled epoch of DeviceLoader batches on the card against
    BatchIterator batches moved by to_device: bit-identical, pad rows zero."""
    from fairmultimodal_torch.data.device import DeviceLoader
    from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
    from fairmultimodal_torch.data.prefetch import to_device

    flat = {k: v[idx] for k, v in arrays.items()}
    dev = DeviceLoader(flat, labels[idx], EXP_BATCH, shuffle=True, seed=seed, device="cuda")
    host = NestedLoader(BatchIterator(dict(flat, labels=labels[idx]), EXP_BATCH, shuffle=True,
                                      seed=seed), arrays)
    n_batches = 0
    for got, want in zip(dev, host):
        want = to_device(want, torch.device("cuda"))
        pad = got["weight"] == 0
        pairs = [("labels", got["labels"], want["labels"]),
                 ("weight", got["weight"], want["weight"])]
        pairs += [(k, v, want["model_inputs"][k]) for k, v in got["model_inputs"].items()]
        for name, g, w in pairs:
            if g.device.type != "cuda" or g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"DeviceLoader batch {n_batches}: {name} differs from "
                                     "the host path")
            if name != "weight" and g[pad].any():
                raise AssertionError(f"DeviceLoader batch {n_batches}: {name} pad rows not zero")
        n_batches += 1
    if n_batches != len(host) or dev.epoch != 1:
        raise AssertionError(f"DeviceLoader: {n_batches} batches, epoch {dev.epoch}")
    return {"batches": n_batches, "pad_rows": int(len(host) * EXP_BATCH - len(idx))}


def experiment_phase(flash, fab, ffn, addnorm):
    """``run_fame_bundle`` at the reference geometry in bf16 with the
    device-resident loaders; launch counts, metric blocks, thresholds and
    artifacts checked; the saved npz reloaded by the predictor."""
    import contextlib
    import glob
    import io
    import os
    import tempfile

    from fairmultimodal_torch.data import featurize
    from fairmultimodal_torch.interop import load_flax_params
    from fairmultimodal_torch.models.bert import bio_clinical_bert_config
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.models.text import TextEncoder
    from fairmultimodal_torch.pipelines.common import build_arrays
    from fairmultimodal_torch.pipelines.fame import FAME_KEYS, FAMEPipelineConfig, run_fame_bundle
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
    from fairmultimodal_torch.utils.checkpoint import load_metadata_npz, load_params_npz

    bert_config = bio_clinical_bert_config()
    bundle = experiment_bundle(featurize, np.random.default_rng(6))
    notes = bundle.note_chunks
    encoder = TextEncoder.from_pretrained(fallback_config=bert_config, dtype=torch.bfloat16,
                                          seed=1, device="cuda")
    geo = {k: v for k, v in TRAIN_GEO.items() if k not in
           ("num_ages", "num_genders", "num_ethnicities", "num_insurances",
            "lab_token_count", "text_embed_size")}

    # The wall time of each train_epoch call (its last step is pulled at its end).
    epoch_s = []
    train_epoch = FAMETrainer.train_epoch

    def timed_train_epoch(self, loader):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_epoch(self, loader)
        epoch_s.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as out_dir:
        cfg = FAMEPipelineConfig(
            train=TrainConfig(lr=1e-4, num_epochs=EXP_EPOCHS, batch_size=EXP_BATCH),
            out_dir=out_dir, dtype="bfloat16", device_data=True, timing=True, **geo)
        FAMETrainer.train_epoch = timed_train_epoch
        _reset_counts(fab, ffn, addnorm)
        flash.launches = flash.bwd_launches = 0
        buf = io.StringIO()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = run_fame_bundle(bundle, cfg, text_encoder=encoder, verbose=True,
                                      device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            FAMETrainer.train_epoch = train_epoch
        counts = _unfolded_counts(fab, ffn)
        counts.update(glue=addnorm.launches, glue_bwd=addnorm.bwd_launches,
                      flash_attention=flash.launches, flash_attention_bwd=flash.bwd_launches)
        printed = buf.getvalue().splitlines()
        log("[experiment] " + "\n[experiment] ".join(printed[:6] + ["..."] + printed[-45:]))

        # Launches: text precompute, then every lab-encoder forward and backward.
        splits = {k: len(v) for k, v in out["splits"].items()}
        nb = {k: -(-n // EXP_BATCH) for k, n in splits.items()}
        epochs = len(out["history"])
        forwards = epochs * (2 * nb["train"] + nb["val"]) + nb["val"] + 2 * nb["test"]
        layers = geo["lab_layers"]
        text = expected_text_launches(encoder.tokenizer, notes, cfg.text_batch_size,
                                      bert_config.num_hidden_layers)
        want = {k: 0 for k in counts}
        want.update(fused_attention_block_ln=text + layers * forwards,
                    fused_ffn_ln=text + layers * forwards,
                    fused_attention_block_ln_bwd=layers * epochs * nb["train"],
                    fused_ffn_ln_bwd=layers * epochs * nb["train"])
        log(f"[experiment] {EXP_PATIENTS} patients, splits {splits}, {epochs} epochs in "
            f"{wall:.1f} s (host clock); launches {counts}, expected {want} (text {text})")
        if epochs != EXP_EPOCHS or counts != want or text == 0:
            raise AssertionError(f"experiment launches {counts}, expected {want}")

        # Metric blocks, thresholds on the 101-point grid, finite AUROC / AP.
        grid = np.linspace(0, 1, 101)
        test_labels = bundle.labels[out["splits"]["test"]]
        if set(out["metrics"]) != {"mortality", "los", "mechanical_ventilation"}:
            raise AssertionError(f"metric blocks {sorted(out['metrics'])}")
        for i, (task, m) in enumerate(out["metrics"].items()):
            both = 0 < test_labels[:, i].sum() < len(test_labels)
            if not both or not (np.isfinite(m["aucroc"]) and np.isfinite(m["auprc"])):
                raise AssertionError(f"{task}: classes present {both}, AUROC {m['aucroc']}, "
                                     f"AP {m['auprc']}")
            if not (grid == out["thresholds"][task]).any():
                raise AssertionError(f"{task}: threshold {out['thresholds'][task]} off the grid")
        if not np.isfinite(out["eddi"]["overall_combined_eddi"]):
            raise AssertionError(f"EDDI {out['eddi']['overall_combined_eddi']}")

        # Artifacts: names, the extracted vectors' keys and shapes, the CSV rows.
        names = sorted(os.listdir(out_dir))
        vec_path = glob.glob(os.path.join(out_dir, "extracted_vectors_*.npz"))
        npz_path = out["artifacts"]["best_model"]
        for name in ("tracked_dynamic_weights.npy", "tracked_sigmoid_weights.npy",
                     "dynamic_weights_per_epoch1.csv"):
            if name not in names:
                raise AssertionError(f"artifact {name} missing: {names}")
        if len(vec_path) != 1 or not os.path.exists(npz_path):
            raise AssertionError(f"artifacts {names}")
        with np.load(vec_path[0]) as vec:
            shapes = {k: vec[k].shape for k in vec.files}
        for k, width in EXP_VECTOR_KEYS.items():
            want_shape = (splits["test"],) + ((width,) if width else ())
            if shapes.get(k) != want_shape:
                raise AssertionError(f"extracted vectors {k}: {shapes.get(k)}, "
                                     f"expected {want_shape}")
        with open(os.path.join(out_dir, "dynamic_weights_per_epoch1.csv")) as f:
            csv_rows = f.read().splitlines()
        if len(csv_rows) != 1 + 3 * epochs:
            raise AssertionError(f"dynamic-weights CSV has {len(csv_rows)} rows")
        tracked = np.load(os.path.join(out_dir, "tracked_sigmoid_weights.npy"))
        if tracked.shape != (epochs, 3 * 256):
            raise AssertionError(f"tracked_sigmoid_weights {tracked.shape}")

        # The saved best state, read back through the port's reader, gives the
        # run's test probabilities.
        meta = load_metadata_npz(npz_path)
        model = load_flax_params(FAMEModel(**meta["model"], dtype=torch.bfloat16),
                                 load_params_npz(npz_path))
        test_arrays = {k: v[out["splits"]["test"]]
                       for k, v in build_arrays(bundle, FAME_KEYS).items()}
        fab.launches = ffn.launches = 0
        probs = FAMEPredictor(model, meta["thresholds"], batch_size=EXP_BATCH,
                              dynamic_weights=meta["dynamic_weights"],
                              device="cuda").predict_arrays(test_arrays)["probs"]
        with np.load(vec_path[0]) as vec:
            run_probs = 1.0 / (1.0 + np.exp(-vec["logits"].astype(np.float64)))
        npz_diff = float(np.abs(probs - run_probs).max())
        log(f"[experiment] best_model npz reloaded: max |p - sigmoid(test logits)| = "
            f"{npz_diff:.3e} (limit {EXP_NPZ_TOL}); lab launches {fab.launches}")
        if not npz_diff <= EXP_NPZ_TOL or fab.launches != layers * nb["test"]:
            raise AssertionError(f"reloaded npz: probabilities differ by {npz_diff}, "
                                 f"{fab.launches} launches")

    loader = device_loader_check(build_arrays(bundle, FAME_KEYS), bundle.labels,
                                 out["splits"]["train"], seed=cfg.train.seed)
    log(f"[experiment] DeviceLoader epoch on the card bit-identical to the host path: {loader}")
    train_pps = [splits["train"] / s for s in epoch_s]
    info = {"patients": EXP_PATIENTS, "splits": splits, "epochs": epochs,
            "wall_s": wall, "timings_s": out["timings"], "train_epoch_s": epoch_s,
            "train_patients_per_sec": train_pps, "launches": counts, "text_launches": text,
            "history": out["history"], "thresholds": out["thresholds"],
            "metrics": {t: {k: m[k] for k in ("aucroc", "auprc", "f1")}
                        for t, m in out["metrics"].items()},
            "overall_combined_eddi": out["eddi"]["overall_combined_eddi"],
            "artifacts": names, "npz_reload_max_abs": npz_diff, "device_loader": loader}
    log(f"[experiment] stage wall times (s): {json.dumps(out['timings'])}; train patients/s "
        f"per epoch {[round(p, 1) for p in train_pps]}")
    del out, model, encoder
    torch.cuda.empty_cache()
    return counts, info


# -- phase 7: the command line (python -m fairmultimodal_torch.cli) ----------------------

CLI_PATIENTS, CLI_LABS, CLI_BATCH, CLI_TEXT_BATCH = 2048, 549, 256, 128
# Whole words in the snapshot's vocabulary; every other word of the synthetic
# notes is spelled in single-character pieces, so the chunks fill every text
# bucket and the 256 / 512 ones run #1 and #2.
CLI_WHOLE_WORDS = ("patient", "stable", "care", "pain", "alert", "clear", "renal", "lasix")
CLI_REVISION = "5f1d6c2a0b9e8d7c6b5a4f3e2d1c0b9a8f7e6d5c"
# predict against the run's own test logits: the same bf16 model and kernels
# on the same rows (row-independent), so equal up to the dynamic weights'
# rounding, as in phase 6.
CLI_PRED_TOL = 1e-3
_HF_LAYER_NAMES = (("attention.query.", "attention.self.query."),
                   ("attention.key.", "attention.self.key."),
                   ("attention.value.", "attention.self.value."),
                   ("attention.output_dense.", "attention.output.dense."),
                   ("attention.output_layer_norm.", "attention.output.LayerNorm."),
                   ("intermediate.", "intermediate.dense."),
                   ("output.", "output.dense."),
                   ("output_layer_norm.", "output.LayerNorm."))


def _hf_name(name):
    """The port's BERT parameter name -> a BertForPreTraining checkpoint's."""
    if name.startswith("embeddings."):
        return "bert." + name.replace("layer_norm", "LayerNorm")
    layer, rest = name.split(".", 1)
    for ours, theirs in _HF_LAYER_NAMES:
        if rest.startswith(ours):
            return f"bert.encoder.layer.{layer.split('_')[1]}.{theirs}{rest[len(ours):]}"
    raise KeyError(name)


def write_hf_snapshot(hub, seed=11):
    """A Bio_ClinicalBERT snapshot in the hub cache layout: BERT-base
    geometry, seeded random weights in a ``pytorch_model.bin`` named as a
    BertForPreTraining checkpoint names them, and a vocabulary that spells
    most note words in single characters.  Returns the snapshot directory."""
    import dataclasses
    import os
    import string

    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.bert import BertEncoderModel, bio_clinical_bert_config

    cfg = bio_clinical_bert_config()
    repo = os.path.join(hub, "models--emilyalsentzer--Bio_ClinicalBERT")
    snap = os.path.join(repo, "snapshots", CLI_REVISION)
    os.makedirs(snap)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(CLI_REVISION)
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(string.ascii_lowercase)
             + ["##" + c for c in string.ascii_lowercase] + list(CLI_WHOLE_WORDS))
    vocab += [f"[unused{i}]" for i in range(100, 100 + cfg.vocab_size - len(vocab))]
    with open(os.path.join(snap, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump({"architectures": ["BertForMaskedLM"], "model_type": "bert",
                   "hidden_act": "gelu", **dataclasses.asdict(cfg)}, f)
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True}, f)
    model = init_params(BertEncoderModel(cfg), seed)
    torch.save({_hf_name(k): v for k, v in model.state_dict().items()},
               os.path.join(snap, "pytorch_model.bin"))
    return snap


def _cli_expect(bundle, tokenizer):
    """What a run on ``bundle`` must launch: the text batches of the 256 /
    512 buckets (and the tokenizer's chunks/s), and the loaders' batches of
    the pipeline's two-stage split."""
    from fairmultimodal_torch.data.split import multilabel_stratified_split

    n_chunks = sum(len(c) for c in bundle.note_chunks)
    t0 = time.perf_counter()
    text = expected_text_launches(tokenizer, bundle.note_chunks, CLI_TEXT_BATCH, 12)
    tok_s = time.perf_counter() - t0
    train_val, test = multilabel_stratified_split(bundle.labels, 0.20, seed=42)
    rel_train, rel_val = multilabel_stratified_split(bundle.labels[train_val], 0.05, seed=42)
    nb = {k: -(-len(v) // CLI_BATCH) for k, v in (("train", rel_train), ("val", rel_val),
                                                     ("test", test))}
    return {"text": text, "nb": nb, "patients": bundle.num_patients, "chunks": n_chunks,
            "tokenizer_chunks_per_s": n_chunks / tok_s,
            "splits": [len(rel_train), len(rel_val), len(test)]}


def _cli_fame_launches(e, epochs, cold_text, layers=2):
    """#1 / #2 and #3 / #4 launches of a ``fame`` run that trains ``epochs``."""
    nb = e["nb"]
    fwd = layers * (epochs * (2 * nb["train"] + nb["val"]) + nb["val"] + 2 * nb["test"])
    return fwd + (e["text"] if cold_text else 0), layers * epochs * nb["train"]


def cli_predicted_launches(e42, e43):
    """Per run, (#1 = #2, #3 = #4) launches: A trains 2 epochs and encodes
    the text, B and C train 1 epoch each from the cache, D scores every
    patient in batches of 256, E trains seed 42 from the cache and seed 43
    with its own text."""
    want = {"A": _cli_fame_launches(e42, 2, True), "B": _cli_fame_launches(e42, 1, False),
            "C": _cli_fame_launches(e42, 1, False),
            "D": (2 * -(-e42["patients"] // CLI_BATCH), 0)}
    e_runs = [_cli_fame_launches(e42, 1, False), _cli_fame_launches(e43, 1, True)]
    want["E"] = (e_runs[0][0] + e_runs[1][0], e_runs[0][1] + e_runs[1][1])
    return want


def _same_state(a, b, path=""):
    """Paths of the entries where two checkpoint states differ (bitwise)."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            return [path]
        return [p for k in a for p in _same_state(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _same_state(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def cli_phase(flash, fab, ffn, addnorm):
    """``python -m fairmultimodal_torch.cli`` in-process on the card at full
    width: a Bio_ClinicalBERT snapshot in a hub cache, then fame (A), fame
    from CSV files for 1 epoch (B), the same checkpoint directory resumed to
    2 epochs (C), predict with A's npz (D), fame --runs 2 (E)."""
    import contextlib
    import gc
    import importlib
    import io
    import os
    import shutil

    from fairmultimodal_torch.data.featurize import assemble_features
    from fairmultimodal_torch.data.synthetic import make_common_frames
    from fairmultimodal_torch.data.table import read_csv_table, write_csv_table
    from fairmultimodal_torch.models.text import TextEncoder
    from fairmultimodal_torch.models.tokenizer import WordPieceTokenizer
    from fairmultimodal_torch.pipelines import fame
    from fairmultimodal_torch.utils.checkpoint import Checkpointer

    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase7")
    d = {k: os.path.join(root, k) for k in ("hub", "text_cache", "data", "CA", "CB", "OA",
                                            "OB", "OC", "OD", "OE")}
    env_keys = ("HF_HUB_CACHE", "FMTPU_TEXT_CACHE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    originals = (fame.run_fame_experiment, Checkpointer.save, Checkpointer.restore,
                 TextEncoder.encode_ids)
    results, ckpt_s, encodes = [], {"save": [], "restore": []}, [0]

    def run_experiment(*args, **kwargs):
        out = originals[0](*args, **kwargs)
        results.append({"timings": out["timings"], "history": out["history"],
                        "splits": {k: v.tolist() for k, v in out["splits"].items()},
                        "best_model": out["artifacts"].get("best_model")})
        return out

    def timed(kind, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            ckpt_s[kind].append(time.perf_counter() - t0)
            return out
        return wrapped

    def counted_encode(self, *args, **kwargs):
        encodes[0] += 1
        return originals[3](self, *args, **kwargs)

    def run(name, argv):
        _reset_counts(fab, ffn, addnorm)
        flash.launches = flash.bwd_launches = 0
        encodes[0], n_results = 0, len(results)
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _unfolded_counts(fab, ffn)
        counts.update(glue=addnorm.launches, glue_bwd=addnorm.bwd_launches,
                      flash_attention=flash.launches, flash_attention_bwd=flash.bwd_launches)
        gc.collect()
        torch.cuda.empty_cache()
        printed = buf.getvalue()
        tail = [ln for ln in printed.splitlines() if ln.startswith(("Resumed", "[Epoch", "  ", "|",
                                                                    "=====", "Wrote", "Train"))]
        log(f"[cli] {name}: rc {rc}, {wall:.2f} s\n[cli]   " + "\n[cli]   ".join(tail[-28:]))
        if rc != 0:
            raise AssertionError(f"cli {name}: exit code {rc}")
        return {"wall_s": wall, "launches": counts, "encode_calls": encodes[0],
                "results": results[n_results:], "stdout": printed}

    try:
        t0 = time.perf_counter()
        snap = write_hf_snapshot(d["hub"])
        snapshot_s = time.perf_counter() - t0
        os.environ["HF_HUB_CACHE"] = d["hub"]
        tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
        os.makedirs(d["data"])
        t0 = time.perf_counter()
        for kind, table in zip(("structured", "unstructured"), tables):
            write_csv_table(os.path.join(d["data"], f"final_{kind}_common.csv"), table)
        csv_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        read_csv_table(os.path.join(d["data"], "final_structured_common.csv"))
        csv_read_s = time.perf_counter() - t0

        # The prediction, made before any run.
        expect = {seed: _cli_expect(assemble_features(*make_common_frames(
            CLI_PATIENTS, CLI_LABS, 3, seed=seed)), WordPieceTokenizer.from_pretrained(snap))
            for seed in (42, 43)}
        e42, e43 = expect[42], expect[43]
        want = cli_predicted_launches(e42, e43)
        log(f"[cli] predicted (#1 = #2, #3 = #4) launches {want}; buckets from the snapshot's "
            f"tokenizer: text launches {e42['text']} / {e43['text']} (seed 42 / 43), splits "
            f"{e42['splits']} / {e43['splits']}")

        fame.run_fame_experiment = run_experiment
        Checkpointer.save = timed("save", originals[1])
        Checkpointer.restore = timed("restore", originals[2])
        TextEncoder.encode_ids = counted_encode
        common = ["--synthetic_labs", str(CLI_LABS), "--bf16", "--bsz", str(CLI_BATCH),
                  "--require_hf_weights", "--text_cache", d["text_cache"], "--timing"]
        syn = ["--synthetic", str(CLI_PATIENTS)] + common
        runs = {
            "A": run("A fame --epochs 2", ["fame", "--epochs", "2", "--checkpoint_dir", d["CA"],
                                           "--out_dir", d["OA"]] + syn),
            "B": run("B fame --epochs 1 --data_dir", [
                "fame", "--epochs", "1", "--checkpoint_dir", d["CB"], "--out_dir", d["OB"],
                "--data_dir", d["data"]] + common),
            "C": run("C fame --epochs 2 (resume)", ["fame", "--epochs", "2", "--checkpoint_dir",
                                                    d["CB"], "--out_dir", d["OC"]] + syn),
        }
        a_out = runs["A"]["results"][0]
        runs["D"] = run("D predict", ["predict", "--params", a_out["best_model"],
                                      "--out_dir", d["OD"]] + syn)
        runs["E"] = run("E fame --runs 2 --epochs 1", ["fame", "--runs", "2", "--epochs", "1",
                                                       "--out_dir", d["OE"]] + syn)

        # Launches of #1-#4 as predicted, every other kernel never.
        for name, r in runs.items():
            got = r["launches"]
            wanted = {k: 0 for k in got}
            wanted.update(fused_attention_block_ln=want[name][0], fused_ffn_ln=want[name][0],
                          fused_attention_block_ln_bwd=want[name][1],
                          fused_ffn_ln_bwd=want[name][1])
            if got != wanted:
                raise AssertionError(f"cli {name}: launches {got}, predicted {wanted}")
        for name, r in runs.items():
            split_sizes = [[len(x["splits"][k]) for k in ("train", "val", "test")]
                           for x in r["results"]]
            if split_sizes and split_sizes[0] != e42["splits"]:
                raise AssertionError(f"cli {name}: splits {split_sizes}, predicted "
                                     f"{e42['splits']}")

        # The text cache: A encodes, B / C / D read it, E encodes seed 43 only.
        if runs["A"]["encode_calls"] == 0 or any(runs[k]["encode_calls"] for k in "BCD"):
            raise AssertionError("text cache: encode calls "
                                 f"{ {k: r['encode_calls'] for k, r in runs.items()} }")
        # Resume: C resumed B's epoch 1, and its state equals A's bit for bit.
        if "Resumed from checkpoint at epoch 1." not in runs["C"]["stdout"]:
            raise AssertionError("cli C did not resume from epoch 1")
        steps = {k: sorted(os.listdir(d[k])) for k in ("CA", "CB")}
        if steps["CA"] != ["step_1.pt", "step_2.pt"] or steps["CB"] != steps["CA"]:
            raise AssertionError(f"checkpoint files {steps}")
        diffs = {}
        for step in (1, 2):
            diffs[step] = _same_state(Checkpointer(d["CA"]).restore(step),
                                      Checkpointer(d["CB"]).restore(step))
        log(f"[cli] A against B (epoch 1, CSV tables) and C (resumed, epoch 2): entries that "
            f"differ {[len(v) for v in diffs.values()]} {diffs[1][:6]} {diffs[2][:6]}")
        if diffs[1] or diffs[2]:
            raise AssertionError(f"resume not bit-identical: step 1 {diffs[1][:10]}, "
                                 f"step 2 {diffs[2][:10]}")
        ckpt_bytes = os.path.getsize(os.path.join(d["CA"], "step_2.pt"))

        # predict: A's test patients against sigmoid of A's extracted test logits.
        pred = read_csv_table(os.path.join(d["OD"], "predictions.csv"))
        vec = [n for n in os.listdir(d["OA"]) if n.startswith("extracted_vectors_")]
        with np.load(os.path.join(d["OA"], vec[0])) as z:
            run_probs = 1.0 / (1.0 + np.exp(-z["logits"].astype(np.float64)))
        bundle = assemble_features(*tables)
        row_of = {s: i for i, s in enumerate(pred["subject_id"].tolist())}
        test_ids = bundle.subject_id[a_out["splits"]["test"]]
        probs = np.stack([pred[f"{t}_prob"] for t in ("mortality", "los",
                                                      "mechanical_ventilation")], axis=1)
        probs = probs[[row_of[s] for s in test_ids.tolist()]]
        pred_diff = float(np.abs(probs - run_probs).max())
        log(f"[cli] predict: {len(row_of)} patients; A's {len(test_ids)} test patients within "
            f"{pred_diff:.3e} of sigmoid(A's test logits) (limit {CLI_PRED_TOL})")
        if len(row_of) != e42["patients"] or not pred_diff <= CLI_PRED_TOL:
            raise AssertionError(f"predict: {len(row_of)} rows, max |dp| {pred_diff}")

        # --runs 2: the Table-3 block and the per-run CSV.
        e_out = runs["E"]["stdout"]
        with open(os.path.join(d["OE"], "runs_aggregate.csv")) as f:
            agg = [line.split(",") for line in f.read().splitlines()]
        per_run = {r: sum(1 for row in agg if row[0] == r) for r in ("0", "1")}
        if ("===== Aggregate over 2 runs (seeds 42..43) =====" not in e_out
                or "| Task        | AUROC ↑ | AUPRC ↑ | EDDI % ↓ | EO % ↓ |" not in e_out
                or per_run != {"0": 12, "1": 12} or len(runs["E"]["results"]) != 2):
            raise AssertionError(f"--runs 2: table or CSV missing ({per_run})")
    finally:
        (fame.run_fame_experiment, Checkpointer.save, Checkpointer.restore,
         TextEncoder.encode_ids) = originals
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)

    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in ("fused_attention_block_ln", "fused_ffn_ln",
                       "fused_attention_block_ln_bwd", "fused_ffn_ln_bwd")}
    info = {
        "patients": CLI_PATIENTS, "splits": e42["splits"], "chunks": e42["chunks"],
        "snapshot_write_s": snapshot_s, "csv_write_s": csv_write_s, "csv_read_s": csv_read_s,
        "tokenizer_chunks_per_s": [e42["tokenizer_chunks_per_s"],
                                   e43["tokenizer_chunks_per_s"]],
        "runs": {k: {"wall_s": r["wall_s"], "encode_calls": r["encode_calls"],
                     "launches": {n: r["launches"][n] for n in total},
                     "timings_s": [x["timings"] for x in r["results"]],
                     "history": [x["history"] for x in r["results"]]}
                 for k, r in runs.items()},
        "text_precompute_s": {"cold_A": runs["A"]["results"][0]["timings"]["text_precompute"],
                              "warm_B": runs["B"]["results"][0]["timings"]["text_precompute"],
                              "warm_C": runs["C"]["results"][0]["timings"]["text_precompute"]},
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": ckpt_s["save"],
        "checkpoint_restore_s": ckpt_s["restore"], "resume_bit_identical": True,
        "predict_max_abs": pred_diff, "launches_predicted": want, "launches_total": total,
    }
    return total, info


# -- phase 8: the baseline pipelines (01, 02, 07, 09, 08) through the command line --------

BASE_BATCH, BASE_TEXT_BATCH, BASE_LAB_S = 16, 32, 560
#: (label, pipeline, flags) of phase 8's runs, each --epochs 1 at the pipeline's batch 16.
BASE_RUNS = (("01 behrt --bf16", "behrt", ["--bf16"]), ("01 behrt fp32", "behrt", []),
             ("02 bioclinicalbert", "bioclinicalbert", []),
             ("07 average --bf16", "average", ["--bf16"]),
             ("09 sigmoid --bf16", "sigmoid", ["--bf16"]), ("08 eddi --bf16", "eddi", ["--bf16"]))
BASE_MODULES = {"behrt": ("behrt", "run_behrt_experiment"),
                "bioclinicalbert": ("text_only", "run_text_only_experiment"),
                "average": ("average_fusion", "run_average_fusion_experiment"),
                "sigmoid": ("sigmoid_fusion", "run_sigmoid_fusion_experiment"),
                "eddi": ("eddi_fusion", "run_eddi_fusion_experiment")}
BASE_SPLITS = {"behrt": "iterstrat", "bioclinicalbert": "skmultilearn", "average": "iterstrat",
               "sigmoid": "sklearn", "eddi": "iterstrat"}
BASE_EXTRA_KEYS = ("segment_ids", "adm_loc_ids", "disch_loc_ids")


def baseline_predicted_launches(tables, tokenizer):
    """Per pipeline, (#1 = #2, #3 = #4) launches of a 1-epoch run, the
    pipeline's split, and the notes cohort: two lab layers per batch of every
    train step, validation and test pass for 01 / 09 / 08, and for 02 the
    text batches of the 256 / 512 buckets; 07 launches none (a one-token BERT,
    text at 128)."""
    from fairmultimodal_torch.data.featurize import assemble_features
    from fairmultimodal_torch.pipelines.common import make_split

    cohorts = {"labs": assemble_features(*tables, require_notes=False),
               "notes": assemble_features(*tables)}
    want, splits = {}, {}
    for name, method in BASE_SPLITS.items():
        bundle = cohorts["labs" if name == "behrt" else "notes"]
        splits[name] = make_split(bundle.labels, 0.20, 0.05, 42, method=method)
        nb = {k: -(-len(v) // BASE_BATCH) for k, v in splits[name].items()}
        want[name] = (2 * (nb["train"] + nb["val"] + nb["test"]), 2 * nb["train"])
    want["bioclinicalbert"] = (expected_text_launches(
        tokenizer, cohorts["notes"].note_chunks, BASE_TEXT_BATCH, 12), 0)
    want["average"] = (0, 0)
    return want, splits, cohorts


def ffn_kernel_rows(ffn, gen, R, H, FF, rate, eps, dtype, f_err, peak):
    """#2 and #4 at R x H x FF (relu, dropout ``rate``) timed: the wrapper (the
    forward with its residuals as a train step runs it; the backward through
    autograd from one kept forward), the plain version, one library
    composition and the bound; ``f_err`` is :func:`ffn_train_check`'s row at
    the shape.  Returns the (forward, backward) rows."""
    F = torch.nn.functional
    es = torch.empty((), dtype=dtype).element_size()
    f_in = [(torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)
            for shape, std in (((R, H), 1.0), ((FF, H), H ** -0.5), ((FF,), 0.02),
                               ((H, FF), FF ** -0.5), ((H,), 0.02))]
    f_in += [1 + 0.1 * torch.randn(H, generator=gen, device="cuda"),
             0.1 * torch.randn(H, generator=gen, device="cuda")]
    g = torch.randn(R, H, generator=gen, device="cuda").to(dtype)
    fkw = dict(activation="relu", ln_eps=eps)
    leaves = _leaves(f_in)
    x, w1, b1, w2, b2, gamma, beta = f_in

    def ffn_fwd():
        return ffn.fused_ffn_ln(*leaves, rate=rate, deterministic=False, seeds=(21, 22), **fkw)

    def ffn_library_fwd():
        y = F.dropout(F.linear(F.dropout(F.relu(F.linear(x, w1, b1)), rate), w2, b2), rate)
        return F.layer_norm(x + y, (H,), gamma.to(dtype), beta.to(dtype), eps)

    out, fwd_ms = ffn_fwd(), time_ms(ffn_fwd)
    with torch.no_grad():
        _, res = ffn.fused_ffn_ln_reference(*f_in, rate=rate, seeds=(21, 22),
                                            return_residuals=True, **fkw)
        fwd_bound = bound_ms(4 * R * H * FF, 2 * R * H * es + 2 * H * FF * es, peak)
        fwd_row = {
            "ms": fwd_ms,
            "plain_ms": time_ms(lambda: ffn.fused_ffn_ln_reference(
                *f_in, rate=rate, seeds=(21, 22), **fkw), reps=5),
            "library_ms": time_ms(ffn_library_fwd),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "max_abs_err": f_err["errors"]["out"]["max_abs_err"]}
        bwd_bound = bound_ms(8 * R * H * FF, (4 * R * H + R * FF + 2 * H * FF) * es, peak)
        plain_bwd = time_ms(lambda: ffn.fused_ffn_ln_backward_reference(
            g, x, res["hd"], res["z"], w1, w2, gamma, rate=rate, seeds=(21, 22), **fkw),
            reps=5)
    bwd_row = {
        "ms": _time_backward(out, leaves, g), "plain_ms": plain_bwd,
        "library_ms": _ffn_library_bwd_ms(f_in, g, "relu", eps, rate),
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "max_abs_err": f_err["errors"]["dx"]["max_abs_err"],
        "stages_run_ms": f_err["ms"], "stages_ms": f_err["stages_ms"],
        "deterministic": f_err["deterministic"]}
    del out, res, leaves
    return fwd_row, bwd_row


def baseline_kernel_rows(fab, ffn, flash, _build, B=BASE_BATCH):
    """#1-#4 at the baselines' lab shape (B 16 x S 560, H 768, 8 heads, FFN
    2048, dropout 0.1) in fp32 and bf16: errors against the plain versions
    (phase 3b's limits), the backward's launches timed one by one
    (``stages_ms``) and run twice for the same bits, then the wrapper's time
    (the forward with its residuals as a train step runs it; the backward
    through autograd from one kept forward), the plain version's, one library
    composition's, and the bound (fp32 operations at the CUDA cores' peak:
    the port's fp32 GEMM and flash kernels use no tensor cores).  Then #5-#10
    in fp32 at the same shape (phase 3c / 3d's checks, timed): what a
    default fp32 run of the unfolded or flash-route layer would pay."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(16)
    S, H, nh, FF, rate, eps = BASE_LAB_S, 768, 8, 2048, 0.1, 1e-5
    rows = {"fused_attention_block_ln": {}, "fused_attention_block_ln_bwd": {},
            "fused_ffn_ln": {}, "fused_ffn_ln_bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        peak = FP32_PEAK if dtype == torch.float32 else BF16_PEAK
        a_err = attention_train_check(fab, _build, gen, dtype, rate, B=B, timed=True, peak=peak)
        f_err = ffn_train_check(ffn, _build, gen, dtype, rate, R=B * S, timed=True, peak=peak)

        inputs, mask, g = _attn_train_case(fab, B, S, H, nh, eps, dtype, gen, N_LABS)
        kw = dict(num_heads=nh, ln_eps=eps)
        leaves = _leaves(inputs)
        x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = inputs
        es, d = x.element_size(), H // nh
        bias = torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]

        def fwd():
            return fab.fused_attention_block_ln(*leaves, mask, rate=rate, deterministic=False,
                                                seed=1234, **kw)

        def library_fwd():
            qkv = F.linear(x, torch.cat((wq, wk, wv)), torch.cat((bq, bk, bv))).view(
                B, S, 3, nh, d)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            y = F.dropout(F.linear(o.transpose(1, 2).reshape(B, S, H), wo, bo), rate)
            return F.layer_norm(x + y, (H,), gamma.to(dtype), beta.to(dtype), eps)

        out, fwd_ms = fwd(), time_ms(fwd)
        with torch.no_grad():
            _, res = fab.fused_attention_block_ln_reference(*inputs, mask, rate=rate, seed=1234,
                                                            return_residuals=True, **kw)
            fwd_bound = bound_ms(B * (8 * S * H * H + 4 * S * S * H),
                                 2 * B * S * H * es + 4 * H * H * es + B * S * 4, peak)
            rows["fused_attention_block_ln"][tag] = {
                "ms": fwd_ms,
                "plain_ms": time_ms(lambda: fab.fused_attention_block_ln_reference(
                    *inputs, mask, rate=rate, seed=1234, **kw), reps=5),
                "library_ms": time_ms(library_fwd),
                "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                "max_abs_err": a_err["errors"]["out"]["max_abs_err"],
                "stages": a_err["fwd_stages"]}
            bwd_bound = bound_ms(B * (16 * S * H * H + 8 * S * S * H),
                                 (8 * B * S * H + 4 * H * H) * es, peak)
            plain_bwd = time_ms(lambda: fab.fused_attention_block_ln_backward_reference(
                g, x, res["qkv"], res["o"], res["z"], wq, wk, wv, wo, gamma, mask, rate=rate,
                seed=1234, **kw), reps=5)
        rows["fused_attention_block_ln_bwd"][tag] = {
            "ms": _time_backward(out, leaves, g), "plain_ms": plain_bwd,
            "library_ms": _attention_library_bwd_ms(inputs, mask, g, nh, eps, rate),
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
            "max_abs_err": a_err["errors"]["dx"]["max_abs_err"],
            "stages_run_ms": a_err["ms"], "stages_ms": a_err["stages_ms"],
            "deterministic": a_err["deterministic"]}
        del out, res, leaves

        rows["fused_ffn_ln"][tag], rows["fused_ffn_ln_bwd"][tag] = ffn_kernel_rows(
            ffn, gen, B * S, H, FF, rate, eps, dtype, f_err, peak)
        torch.cuda.empty_cache()

    # #5-#10 in fp32 at B 16: the forward as a train step runs it (with its
    # residuals), the backward from its cotangent.
    f32, tag = torch.float32, "float32"
    blk = block_check(fab, gen, f32, B=B, timed=True, peak=FP32_PEAK)
    uffn = unfolded_ffn_check(ffn, gen, f32, rate, R=B * S, timed=True, peak=FP32_PEAK)
    fl = flash_check(flash, gen, f32, B=B, S=S, nh=nh, d=H // nh, mask_kind="lab", timed=True,
                     peak=FP32_PEAK, stages=False)     # the 01 step's profile splits them
    for name, row, fwd_err, bwd_err in (
            ("fused_attention_block", blk, blk["forward"]["max_abs_err"],
             blk["errors"]["dx"]["max_abs_err"]),
            ("fused_ffn", uffn, uffn["forward"]["max_abs_err"],
             uffn["errors"]["dx"]["max_abs_err"]),
            ("flash_attention", fl, fl["errors"]["o"]["max_abs_err"],
             max(fl["errors"][n]["max_abs_err"] for n in FLASH_GRADS))):
        rows[name] = {tag: {"ms": row["fwd_res_ms"], "plain_ms": row["plain_ms"],
                            "library_ms": row["library_ms"], "bound_ms": row["bound_ms"],
                            "bound_by": row["bound_by"], "max_abs_err": fwd_err}}
        rows[name + "_bwd"] = {tag: {
            "ms": row["bwd_ms"], "plain_ms": row["plain_bwd_ms"],
            "library_ms": row["library_bwd_ms"], "bound_ms": row["bwd_bound_ms"],
            "bound_by": row["bwd_bound_by"], "max_abs_err": bwd_err,
            "stages_ms": row.get("bwd_stages_ms"), "deterministic": row["bwd_deterministic"]}}
    for name, row in rows.items():
        log(f"[baselines] kernel {name} at B{B} S{S}: {json.dumps(row)}")
    return rows


def _baseline_models():
    """(name, model factory(dtype), batch keys, train config) of the five
    baselines at full width, for the card-vs-CPU steps and the timed 01 step."""
    from fairmultimodal_torch.models import baselines as mb
    from fairmultimodal_torch.pipelines import (AverageFusionPipelineConfig,
                                                BEHRTPipelineConfig, EDDIFusionPipelineConfig,
                                                SigmoidFusionPipelineConfig,
                                                TextOnlyPipelineConfig)

    demo = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "gender_ids", "ethnicity_ids",
            "insurance_ids")
    geo = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6,
               lab_token_count=N_LABS)
    return (
        ("01", lambda dt: mb.BEHRTLabOnlyModel(N_LABS, dtype=dt), ("lab_features",),
         BEHRTPipelineConfig().train),
        ("02", lambda dt: mb.TextOnlyClassifier(dtype=dt), ("text_embedding",),
         TextOnlyPipelineConfig().train),
        ("07", lambda dt: mb.StructTextModel(4, dtype=dt),
         demo + BASE_EXTRA_KEYS + ("text_embedding",), AverageFusionPipelineConfig().train),
        ("09", lambda dt: mb.SigmoidFusionFull(**geo, dtype=dt),
         demo + ("lab_features", "text_embedding"), SigmoidFusionPipelineConfig().train),
        ("08", lambda dt: mb.EDDIFusionFull(**geo, dtype=dt),
         demo + ("lab_features", "text_embedding"), EDDIFusionPipelineConfig().train),
    )


def _baseline_batch(keys, device, n=BASE_BATCH, seed=8):
    from fairmultimodal_torch.data.prefetch import to_device

    a = synthetic_cohort(np.random.default_rng(seed), n)
    a.update({k: np.zeros(n, np.int32) for k in BASE_EXTRA_KEYS})
    return to_device({"model_inputs": {k: a[k] for k in keys}, "labels": a["labels"],
                      "weight": np.ones(n, np.float32)}, torch.device(device))


def baseline_fp32_step(name, factory, keys, cfg, device, dtype=torch.float32, prepare=None,
                       batch=None, loss_extras=None, pos_weight=POS_WEIGHT, init=None):
    """One fp32 train step with dropout on (for 08, its loss and backward),
    from seed-0 weights and generator seed 5: (loss, grads on the host).
    ``dtype=torch.float64`` runs the same step in float64 (on the CPU: the
    reference every grad leaf is held against).  ``prepare(model)`` is
    called on the model just before the step (hooks).  ``batch``: host
    arrays in the trainer's schema (default: the baselines' 16 patients);
    ``loss_extras`` goes to the trainer; ``init``: the seed-0 model, built
    once for a model's steps (a copy is stepped)."""
    import copy
    import dataclasses

    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.pipelines.eddi_fusion import (EDDIFusionPipelineConfig,
                                                            make_eddi_fusion_loss)
    from fairmultimodal_torch.train.simple import MultitaskTrainer
    from fairmultimodal_torch.utils.rng import make_generator

    model = (copy.deepcopy(init) if init is not None
             else init_params(factory(torch.float32), seed=0))
    batch = (_baseline_batch(keys, device) if batch is None
             else to_device(batch, torch.device(device)))
    if dtype == torch.float64:
        weights = model.state_dict()
        model = factory(dtype).to(dtype)
        model.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
        batch = {k: ({n: t.to(dtype) if t.is_floating_point() else t for n, t in v.items()}
                     if isinstance(v, dict) else v.to(dtype)) for k, v in batch.items()}
    if prepare is not None:
        prepare(model)
    if name == "08":
        model.to(device).train()
        loss_fn = make_eddi_fusion_loss(model, EDDIFusionPipelineConfig(), POS_WEIGHT)
        loss, _, _ = loss_fn(batch, torch.full((3, 3), 0.33, device=device), make_generator(5))
        loss.backward()
    else:
        trainer = MultitaskTrainer(model, dataclasses.replace(cfg, seed=5), pos_weight,
                                   device=device, loss_extras=loss_extras)
        loss = trainer.train_step(batch)
    return float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                         if p.grad is not None}


# -- phases 8, 9: where a lab encoder's fp32 grad of W1 parts from float64 --------------
#
# The card's fp32 step of 09 or legacy-eddi can miss the float64 grad of
# behrt_lab.layer_0.ffn_in.weight by several times the CPU fp32 step's error.  The replay taps each lab layer
# of the three steps (card fp32, CPU fp32, CPU float64; same weights, batch
# and dropout seeds): its input x, its output and the output's grad.  From
# each step's own x it recomputes the layer stage by stage -- the card with
# its kernels (#1's QKV GEMM, flash forward and add_layernorm; W1's
# pre-activation by the same "nt" GEMM without the relu; #2; the LayerNorm
# backward and the gated "nn" dh of #4), the CPU fp32 and float64 (on the
# card) with the plain route's operations -- and holds every activation,
# the relu gates of W1's pre-activation and dh against float64.  Then it
# splits the leaf's error over W1's rows: those with a relu gate the card's
# fp32 sets otherwise than float64, and the rest.

#: The models whose card step is replayed and held by :func:`lab_grad_rule`: 09 in
#: phase 8, legacy-eddi (the same lab encoder under the EDDI dot fusion) in phase 9.
REPLAY_MODELS, REPLAY_LEAF = ("09", "legacy-eddi"), "behrt_lab.layer_0.ffn_in.weight"


def _lab_layer_taps(store):
    """``prepare`` for :func:`baseline_fp32_step`: per lab layer i, store[i]
    gets the layer's input x, mask, output, the output's grad and the three
    dropout seeds it draws (attention, FFN inner, FFN outer)."""
    from fairmultimodal_torch.models import behrt as mbehrt

    def prepare(model):
        lab = model.behrt_lab
        current = [None]
        draw = mbehrt.dropout_seed

        def recording(module, rate, generator, sharded=False):
            seed = draw(module, rate, generator, sharded)
            if current[0] is not None and seed is not None:
                store[current[0]]["seeds"].append(seed)
            return seed

        mbehrt.dropout_seed = recording
        store["restore"] = lambda: setattr(mbehrt, "dropout_seed", draw)
        for i in range(lab.num_layers):
            def pre(mod, args, i=i):
                current[0] = i
                store[i] = {"x": args[0].detach().clone(), "mask": args[1], "seeds": []}

            def post(mod, args, out, i=i):
                current[0] = None
                store[i]["out"] = out.detach().clone()
                out.register_hook(lambda g: store[i].__setitem__("g", g.detach().clone()))

            layer = getattr(lab, f"layer_{i}")
            layer.register_forward_pre_hook(pre)
            layer.register_forward_hook(post)
    return prepare


def _plain_layer_parts(layer, tap, dtype, device):
    """One lab layer on the plain route's operations in ``dtype`` on
    ``device`` from a tap's x and seeds: q, k, v, o, x1, h (W1's
    pre-activation), out, and dh (the grad of h from the tap's output grad)."""
    from fairmultimodal_torch.ops.attention import attention_reference
    from fairmultimodal_torch.utils.rng import Dropout, apply_dropout

    F = torch.nn.functional
    x = tap["x"].to(device, dtype)
    mask = tap["mask"].to(device)
    b, s, hd = x.shape
    nh, rate, eps = layer.num_heads, layer.dropout_rate, layer.layer_norm_eps
    attn_seed, inner, outer = tap["seeds"]

    def w(lin):
        return lin.weight.to(device, dtype), lin.bias.to(device, dtype)

    def ln(z, norm):
        return F.layer_norm(z, (hd,), norm.weight.to(device, dtype), norm.bias.to(device, dtype),
                            eps)

    with torch.no_grad():
        q, k, v = (F.linear(x, *w(lin)) for lin in (layer.query, layer.key, layer.value))
        heads = [t.view(b, s, nh, hd // nh).transpose(1, 2) for t in (q, k, v)]
        o = attention_reference(*heads, mask).transpose(1, 2).reshape(b, s, hd)
        y = apply_dropout(F.linear(o, *w(layer.attn_out)), Dropout.make(attn_seed, 0, rate))
        x1 = ln(x + y, layer.norm1)
    h = F.linear(x1, *w(layer.ffn_in)).requires_grad_(True)
    a = apply_dropout(torch.relu(h), Dropout.make(inner, 0, rate))
    y2 = apply_dropout(F.linear(a, *w(layer.ffn_out)), Dropout.make(outer, 1, rate))
    out = ln(x1 + y2, layer.norm2)
    dh, = torch.autograd.grad(out, h, tap["g"].to(device, dtype))
    return {"q": q, "k": k, "v": v, "o": o, "x1": x1, "h": h.detach(), "out": out.detach(),
            "dh": dh}


def _card_layer_parts(fab, ffn, _build, layer, tap):
    """The same parts of one lab layer from the card's kernels on the card
    step's x and seeds; ``out`` must equal the step's own output bit for bit."""
    from fairmultimodal_torch.utils.rng import Dropout

    x, mask = tap["x"], tap["mask"].to(torch.int32).contiguous()
    b, s, hd = x.shape
    nh, rate, eps = layer.num_heads, layer.dropout_rate, layer.layer_norm_eps
    attn_seed, inner, outer = tap["seeds"]
    p = [t.detach() for lin in (layer.query, layer.key, layer.value, layer.attn_out)
         for t in (lin.weight, lin.bias)]
    with torch.no_grad():
        stages, x1, saved = fab.half_layer_stages(
            x, *p, layer.norm1.weight, layer.norm1.bias, mask, num_heads=nh, ln_eps=eps,
            dropout=_keyed(Dropout.make(attn_seed, 0, rate)), residuals=True)
        fab._run(stages)
        x1r = x1.view(b * s, hd)
        w1, b1 = layer.ffn_in.weight.detach(), layer.ffn_in.bias.detach()
        w2, b2 = layer.ffn_out.weight.detach(), layer.ffn_out.bias.detach()
        h = torch.empty(b * s, w1.shape[0], device=x.device)
        _build.gemm(x1r, w1, h, bias=b1)
        inner_d, outer_d = (_keyed(Dropout.make(inner, 0, rate)),
                            _keyed(Dropout.make(outer, 1, rate)))
        stages, out, saved2 = ffn.half_layer_stages(
            x1r, w1, b1, w2, b2, layer.norm2.weight, layer.norm2.bias, activation="relu",
            ln_eps=eps, inner=inner_d, outer=outer_d, residuals=True)
        fab._run(stages)
        g = tap["g"].reshape(b * s, hd).contiguous()
        dz = torch.empty(b * s, hd, device=x.device)
        dy = torch.empty_like(dz)
        part = torch.empty(3, -(-b * s // _build.LN_BWD_ROWS), hd, device=x.device)
        _build.layernorm_bwd(g, saved2["z"], layer.norm2.weight.detach().float().contiguous(),
                             dz, dy, part, eps, outer_d)
        dh = torch.empty_like(h)
        _build.gemm(dy, w2.contiguous(), dh, layout="nn", gate=saved2["hd"], gate_kind="relu",
                    gate_scale=inner_d.inv_keep,
                    colpart=torch.empty(-(-b * s // 128), w1.shape[0], device=x.device))
    if not torch.equal(out.view(b, s, hd), tap["out"]):
        raise AssertionError("replay: the card's layer output differs from the step's")
    qkv = saved["qkv"]
    return {"q": qkv[..., :hd], "k": qkv[..., hd:2 * hd], "v": qkv[..., 2 * hd:],
            "o": saved["o"], "x1": x1, "h": h.view(b, s, -1), "out": out.view(b, s, hd),
            "dh": dh.view(b, s, -1)}


def w1_replay(fab, ffn, _build, factory, taps, grads):
    """Where the card's fp32 step of a REPLAY_MODELS model first parts from
    float64 more than the CPU's fp32 step does, per lab layer and stage, the relu gates of W1
    that flip against float64, and the leaf's error split over W1's rows
    with and without a flipped gate.  ``taps`` and ``grads``: per step
    ("card", "cpu", "f64") the lab-layer taps and the grad leaves."""
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.utils.rng import dropout_mask

    lab = init_params(factory(torch.float32), seed=0).behrt_lab    # the steps' weights
    report, flips, tokens = {}, {}, {}
    for i in range(lab.num_layers):
        layer = getattr(lab, f"layer_{i}")
        seeds = [taps[who][i]["seeds"] for who in ("card", "cpu", "f64")]
        if not seeds[0] == seeds[1] == seeds[2] or len(seeds[0]) != 3:
            raise AssertionError(f"replay: lab layer {i} dropout seeds differ: {seeds}")
        parts = {"card": _card_layer_parts(fab, ffn, _build, layer.cuda(), taps["card"][i]),
                 "cpu": _plain_layer_parts(layer.cpu(), taps["cpu"][i], torch.float32, "cpu"),
                 "f64": _plain_layer_parts(layer.cuda(), taps["f64"][i], torch.float64, "cuda")}
        ref = parts["f64"]
        rows = {}
        for name in ("x", "q", "k", "v", "o", "x1", "h", "out", "g", "dh"):
            want = (taps["f64"][i][name].cuda() if name in ("x", "g") else ref[name]).double()
            scale = want.abs().max().item()
            rows[name] = {}
            for who in ("card", "cpu"):
                got = taps[who][i][name] if name in ("x", "g") else parts[who][name]
                rows[name][who] = (got.cuda().double() - want).abs().max().item() / scale
        # A relu gate counts where the inner dropout keeps the element.
        kept = dropout_mask(seeds[0][1], 0, ref["h"].shape, layer.dropout_rate, device="cuda")
        for who in ("card", "cpu"):
            h = parts[who]["h"].cuda()
            flipped = kept & ((h > 0) != (ref["h"] > 0))
            idx = flipped.nonzero()
            rows[f"relu_flips_{who}"] = {
                "count": len(idx), "kept": int(kept.sum()),
                "h_f64_max_at_flip": float(ref["h"][flipped].abs().max()) if len(idx) else 0.0,
                "h_f64": [float(ref["h"][tuple(j)]) for j in idx[:8]],
                f"h_{who}": [float(h[tuple(j)]) for j in idx[:8]],
                "max_abs_h": float(ref["h"].abs().max())}
            flips[(i, who)] = sorted({int(j[-1]) for j in idx})
            tokens[(i, who)] = sorted({int(j[1]) for j in idx})
            rows[f"relu_flips_{who}"].update(units=flips[(i, who)], tokens=tokens[(i, who)])
        report[f"layer_{i}"] = rows
        del parts, ref
        torch.cuda.empty_cache()
    want = grads["f64"][REPLAY_LEAF].double()
    scale = want.abs().max().item()
    split = {}
    for who in ("card", "cpu"):
        err = (grads[who][REPLAY_LEAF].double() - want).abs().amax(dim=1) / scale
        rows_flipped = flips[(0, who)]
        rest = torch.ones_like(err, dtype=torch.bool)
        rest[rows_flipped] = False
        split[who] = {"all": err.max().item(), "rows_with_a_flip": rows_flipped[:16],
                      "rows_with_a_flip_err": err[rows_flipped].max().item()
                      if rows_flipped else 0.0,
                      "other_rows": err[rest].max().item()}
    report["leaf_split"] = {"leaf": REPLAY_LEAF, **split}
    return report


#: The lab encoder's grad rule (:func:`lab_grad_rule`): each activation of the replayed
#: lab layers within REPLAY_ACT_TOL of float64's max-abs (fp32 rounding: the card reads
#: 1-3e-6); every relu gate the card's or the CPU's fp32 sets otherwise than float64
#: within REPLAY_FLIP_TOL of max |h| of zero (a flip at rounding level); the card flips
#: at most REPLAY_FLIP_CAP times as many of a layer's kept gates as the CPU's fp32
#: (counted as at least 2); and W1's and b1's entries outside a flipped unit within
#: REPLAY_REST_SHARE of phase 8's limit.
REPLAY_ACT_TOL, REPLAY_FLIP_TOL, REPLAY_FLIP_CAP, REPLAY_REST_SHARE = 1e-5, 1e-5, 4, 0.1


def lab_grad_rule(card, cpu, ref, replay):
    """Phase 8's rule for a replayed step (REPLAY_MODELS), one rule for both.

    A kept relu gate of a lab layer's W1 whose fp32 pre-activation lies on the
    other side of zero than float64's (within rounding of zero) sends that
    element's whole gradient one way or the other: W1's row and b1's entry of
    the unit, and through the residual the positional row of the token, then
    differ from float64 by what that one element carries, whatever the fp32
    arithmetic.  So every leaf is held by phase 8's rule with those rows (the
    card's flips and the CPU's) set to float64, provided the replay finds every
    activation within REPLAY_ACT_TOL of float64, every flip within
    REPLAY_FLIP_TOL of zero and the card's flips within REPLAY_FLIP_CAP of the
    CPU's; W1 and b1 are then held to REPLAY_REST_SHARE of the limit.  Any
    other leaf gets phase 8's rule unchanged.  Returns (each leaf's share of
    its limit, the rows set to float64)."""
    drop = {}
    for layer, rows in replay.items():
        if not layer.startswith("layer_"):
            continue
        for name in ("x", "q", "k", "v", "o", "x1", "h", "out"):
            if not rows[name]["card"] <= REPLAY_ACT_TOL:
                raise AssertionError(f"replay {layer} {name}: card {rows[name]['card']} of "
                                     f"float64's max-abs > {REPLAY_ACT_TOL}")
        card_flips, cpu_flips = (rows[f"relu_flips_{who}"]["count"] for who in ("card", "cpu"))
        if not card_flips <= REPLAY_FLIP_CAP * max(cpu_flips, 2):
            raise AssertionError(f"replay {layer}: the card flips {card_flips} relu gates, the "
                                 f"CPU {cpu_flips} (cap {REPLAY_FLIP_CAP}x)")
        units, tokens = set(), set()
        for who in ("card", "cpu"):
            f = rows[f"relu_flips_{who}"]
            if not f["h_f64_max_at_flip"] <= REPLAY_FLIP_TOL * f["max_abs_h"]:
                raise AssertionError(f"replay {layer} {who}: a relu gate flips at |h| "
                                     f"{f['h_f64_max_at_flip']} of max {f['max_abs_h']}")
            units.update(f["units"])
            tokens.update(t for t in f["tokens"] if t < N_LABS)
        for leaf in ("weight", "bias"):
            drop[f"behrt_lab.{layer}.ffn_in.{leaf}"] = sorted(units)
        drop["behrt_lab.pos_embedding"] = sorted(set(drop.get("behrt_lab.pos_embedding", ()))
                                                 | tokens)

    def kept(grads):
        out = dict(grads)
        for n, rows in drop.items():
            if rows:
                out[n] = grads[n].clone()
                out[n][rows] = ref[n][rows].to(out[n].dtype)
        return out

    card_ref, cpu_ref = grad_errors(kept(card), ref), grad_errors(kept(cpu), ref)
    share = {n: (card_ref[n] - cpu_ref[n]) / XDEV_GRAD_TOL for n in card_ref}
    for n in drop:
        if n.endswith(".ffn_in.weight") or n.endswith(".ffn_in.bias"):
            share[n] /= REPLAY_REST_SHARE
    return share, drop


def replayed_shares(fab, ffn, _build, factory, taps, card, cpu, ref, report):
    """For a step of REPLAY_MODELS: the replay and :func:`lab_grad_rule`'s
    readings added to ``report``; returns each leaf's share of its limit."""
    replay = w1_replay(fab, ffn, _build, factory, taps,
                       {"card": card[1], "cpu": cpu[1], "f64": ref})
    share, rows = lab_grad_rule(card[1], cpu[1], ref, replay)
    tight = max(share, key=share.get)
    report.update(w1_replay=replay, rows_set_to_f64=rows,
                  tightest_lab_rule={"leaf": tight, "share_of_limit": share[tight]})
    return share


#: Timed steps (CUDA-event median) of phase 8's step rows.
BASE_TIMED_STEPS = 10


def fame_default_step(n=BASE_BATCH, seed=9):
    """``FAMETrainer.train_step`` as a default ``fame`` run trains: fp32, the
    default ``TrainConfig`` (batch 16), dropout on, the reference geometry
    with seed-0 weights; the CUDA-event median of 10 after warm-up and the
    profiler's split."""
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    trainer = FAMETrainer(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0),
                          TrainConfig(), pos_weight=POS_WEIGHT, rngs_seed=0, device="cuda")
    if trainer.config.batch_size != n:
        raise AssertionError(f"TrainConfig's batch size {trainer.config.batch_size}, not {n}")
    a = synthetic_cohort(np.random.default_rng(seed), n)
    keys = [k for k in a if k != "labels"]
    batch = to_device({"model_inputs": {k: a[k] for k in keys}, "labels": a["labels"],
                       "weight": np.ones(n, np.float32)}, trainer.device)
    out = {"timed": time_train_step(trainer, batch, steps=BASE_TIMED_STEPS),
           "profile": profile_train_step(trainer, batch)}
    del trainer, batch
    return out


def baseline_phase(flash, fab, ffn, addnorm, _build):
    """The five baselines through ``cli.main`` in-process on the card at full
    width (phase 7's cohort and snapshot, 1 epoch each at batch 16), with the
    launches of #1-#4 predicted before the runs; then one fp32 step of each
    model card against CPU, the 01 step timed in bf16 and fp32 and profiled,
    and #1-#4 timed at the baselines' shape."""
    import contextlib
    import gc
    import importlib
    import io
    import os
    import shutil

    from fairmultimodal_torch.data.synthetic import make_common_frames
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.tokenizer import WordPieceTokenizer
    from fairmultimodal_torch.train.simple import MultitaskTrainer

    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase8")
    env_keys = ("HF_HUB_CACHE", "FMTPU_TEXT_CACHE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    modules = {name: importlib.import_module(f"fairmultimodal_torch.pipelines.{mod}")
               for name, (mod, _) in BASE_MODULES.items()}
    originals = {name: getattr(modules[name], fn) for name, (_, fn) in BASE_MODULES.items()}
    results = []

    def recording(name):
        def run(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            results.append(out)
            return out
        return run

    runs = {}
    try:
        snap = write_hf_snapshot(os.path.join(root, "hub"))
        os.environ["HF_HUB_CACHE"] = os.path.join(root, "hub")
        tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
        want, splits, cohorts = baseline_predicted_launches(
            tables, WordPieceTokenizer.from_pretrained(snap))
        log(f"[baselines] predicted (#1 = #2, #3 = #4) launches {want}; splits "
            f"{ {k: [len(v[s]) for s in ('train', 'val', 'test')] for k, v in splits.items()} }")
        for name, (_, fn) in BASE_MODULES.items():
            setattr(modules[name], fn, recording(name))
        common = ["--synthetic", str(CLI_PATIENTS), "--synthetic_labs", str(CLI_LABS),
                  "--epochs", "1", "--require_hf_weights", "--text_cache",
                  os.path.join(root, "text_cache")]
        for label, name, flags in BASE_RUNS:
            out_dir = os.path.join(root, label.split()[0] + ("_fp32" if not flags else ""))
            _reset_counts(fab, ffn, addnorm)
            flash.launches = flash.bwd_launches = 0
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([name, "--out_dir", out_dir] + flags + common)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _all_counts(flash, fab, ffn, addnorm)
            if rc != 0:
                raise AssertionError(f"baseline {label}: exit code {rc}")
            out = results.pop()
            out = {"idx": out["prep"].idx, **{k: out[k] for k in ("metrics", "timings",
                                                                    "history", "weights")
                                               if k in out}}
            tail = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith(("[Epoch", "Train size", "After filtering", "Updated",
                                      "Overall Combined", "Saved"))]
            runs[label] = {"name": name, "wall_s": wall, "launches": counts, "out": out,
                           "out_dir": out_dir}
            log(f"[baselines] {label}: {wall:.2f} s, timings {json.dumps(out['timings'])}\n"
                "[baselines]   " + "\n[baselines]   ".join(tail))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for name, (_, fn) in BASE_MODULES.items():
            setattr(modules[name], fn, originals[name])
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    try:
        for label, r in runs.items():
            name, out = r["name"], r["out"]
            wanted = {k: 0 for k in r["launches"]}
            wanted.update(fused_attention_block_ln=want[name][0], fused_ffn_ln=want[name][0],
                          fused_attention_block_ln_bwd=want[name][1],
                          fused_ffn_ln_bwd=want[name][1])
            if r["launches"] != wanted:
                raise AssertionError(f"baseline {label}: launches {r['launches']}, predicted "
                                     f"{wanted}")
            for task, m in out["metrics"].items():
                if not (np.isfinite(m["aucroc"]) and np.isfinite(m["auprc"])):
                    raise AssertionError(f"baseline {label} {task}: metrics {m}")
            for k, v in splits[name].items():
                if not np.array_equal(out["idx"][k], v):
                    raise AssertionError(f"baseline {label}: {k} split differs from the "
                                         "split worked out beforehand")
            # The train stage holds each epoch's validation pass too.
            r["train_patients_per_fit_s"] = (len(splits[name]["train"])
                                             / out["timings"]["train"])
        with np.load(os.path.join(runs["07 average --bf16"]["out_dir"],
                                  "extracted_embeddings.npz")) as z:
            emb_shape = z["embeddings"].shape
        if emb_shape != (cohorts["notes"].num_patients, 512):
            raise AssertionError(f"07 extracted_embeddings {emb_shape}")
        weights = np.asarray(runs["08 eddi --bf16"]["out"]["weights"])
        if weights.shape != (3, 3) or not np.isfinite(weights).all():
            raise AssertionError(f"08 weights {weights}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[baselines] 07 extracted_embeddings {emb_shape}; 08 weights {weights.tolist()}")

    # fp32 card vs CPU: one step of each model at full width on 16 patients.
    # The loss is held to phase 5's limit against the CPU.  Every grad leaf is
    # held against the same step in float64 on the CPU: the card's fp32 grad
    # may miss the float64 one by phase 5's limit (XDEV_GRAD_TOL of the
    # leaf's max-abs) more than the CPU's fp32 grad misses it.  Where the CPU
    # is exact this is phase 5's limit; a leaf whose fp32 rounding is large
    # on the CPU too (01's pos_embedding: a sum over 16 x 560 rows) gets
    # that rounding as its scale.  Every leaf within phase 5's limit of the
    # CPU passes this rule as well (triangle inequality).
    xdev = {}
    for name, factory, keys, cfg in _baseline_models():
        taps = {who: {} for who in ("card", "cpu", "f64")}
        init = init_params(factory(torch.float32), seed=0)     # one init per model

        def tap(who):
            return _lab_layer_taps(taps[who]) if name in REPLAY_MODELS else None

        try:
            fab.bwd_launches = ffn.bwd_launches = 0
            card = baseline_fp32_step(name, factory, keys, cfg, "cuda", prepare=tap("card"),
                                      init=init)
            lab_bwd = min(fab.bwd_launches, ffn.bwd_launches)
            taps["card"].pop("restore", lambda: None)()
            cpu = baseline_fp32_step(name, factory, keys, cfg, "cpu", prepare=tap("cpu"),
                                     init=init)
            taps["cpu"].pop("restore", lambda: None)()
            _, ref = baseline_fp32_step(name, factory, keys, cfg, "cpu", torch.float64,
                                        prepare=tap("f64"), init=init)
        finally:
            for t in taps.values():
                t.pop("restore", lambda: None)()
        loss_rel, worst, grad_rel = compare_steps(card, cpu)
        card_ref, cpu_ref = grad_errors(card[1], ref), grad_errors(cpu[1], ref)
        margin = {n: (card_ref[n] - cpu_ref[n]) / XDEV_GRAD_TOL for n in card_ref}
        tight = max(margin, key=margin.get)

        def readings(n):
            return {"card_vs_f64": card_ref[n], "cpu_fp32_vs_f64": cpu_ref[n]}

        xdev[name] = {"loss_card": card[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
                      "worst_grad": worst, "worst_grad_rel": grad_rel,
                      "tightest_vs_f64": {"leaf": tight, "share_of_limit": margin[tight],
                                          **readings(tight)},
                      "over_card_vs_cpu_limit": {
                          n: {"card_vs_cpu": e, **readings(n)}
                          for n, e in grad_errors(card[1], cpu[1]).items() if e > XDEV_GRAD_TOL},
                      "lab_bwd_launches": lab_bwd}
        if name in REPLAY_MODELS:
            margin = replayed_shares(fab, ffn, _build, factory, taps, card, cpu, ref, xdev[name])
        del taps
        log(f"[baselines] fp32 step {name} card vs CPU and float64: {json.dumps(xdev[name])}")
        over = sorted(n for n, m in margin.items() if not m <= 1.0)
        if not loss_rel <= XDEV_LOSS_TOL or over:
            raise AssertionError(f"baseline {name} fp32 card vs CPU: loss rel {loss_rel}, "
                                 f"grads over the limit {over} {xdev[name]}")
        if (lab_bwd > 0) != (name in ("01", "09", "08")):
            raise AssertionError(f"baseline {name}: lab backward launches {lab_bwd}")

    # The 01 train step at batch 16, bf16 and fp32, then profiled.
    step = {}
    name, factory, keys, cfg = _baseline_models()[0]
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bfloat16" if dtype == torch.bfloat16 else "float32"
        trainer = MultitaskTrainer(init_params(factory(dtype), seed=0), cfg, POS_WEIGHT,
                                   device="cuda")
        batch = _baseline_batch(keys, "cuda")
        step[tag] = {"timed": time_train_step(trainer, batch, steps=BASE_TIMED_STEPS),
                     "profile": profile_train_step(trainer, batch)}
        log(f"[baselines] 01 train step {tag}: {json.dumps(step[tag])}")
        del trainer
        torch.cuda.empty_cache()

    # FAME's default step: what `fame` trains unless --bf16 is given (fp32,
    # TrainConfig's batch 16, the model's dropout 0.1) at the reference geometry.
    step["fame_default_float32"] = fame_default_step()
    log(f"[baselines] FAME default train step fp32 B16: "
        f"{json.dumps(step['fame_default_float32'])}")
    torch.cuda.empty_cache()

    # 07's step in bf16 with and without dropout: the difference is what the
    # int64 Philox dropout of its per-row BERT costs (ROADMAP queue 3).
    name, factory, keys, cfg = _baseline_models()[2]
    trainer = MultitaskTrainer(init_params(factory(torch.bfloat16), seed=0), cfg, POS_WEIGHT,
                               device="cuda")
    batch = _baseline_batch(keys, "cuda")
    step["07_bfloat16"] = {"dropout": time_train_step(trainer, batch, steps=BASE_TIMED_STEPS)}
    trainer.config.deterministic_forward = True
    step["07_bfloat16"]["no_dropout"] = time_train_step(trainer, batch, steps=BASE_TIMED_STEPS)
    on, off = (step["07_bfloat16"][k]["train_step_ms"] for k in ("dropout", "no_dropout"))
    step["07_bfloat16"]["dropout_share"] = (on - off) / on
    log(f"[baselines] 07 train step bf16: {json.dumps(step['07_bfloat16'])}")
    del trainer
    torch.cuda.empty_cache()

    kernel_rows = baseline_kernel_rows(fab, ffn, flash, _build)
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in ("fused_attention_block_ln", "fused_ffn_ln",
                       "fused_attention_block_ln_bwd", "fused_ffn_ln_bwd")}
    info = {
        "launches_predicted": {label: want[r["name"]] for label, r in runs.items()},
        "launches_total": total,
        "runs": {label: {"wall_s": r["wall_s"], "timings_s": r["out"]["timings"],
                         "train_patients_per_fit_s": r["train_patients_per_fit_s"],
                         "history": r["out"]["history"],
                         "splits": [len(splits[r["name"]][k]) for k in ("train", "val", "test")],
                         "launches": {k: r["launches"][k] for k in total}}
                 for label, r in runs.items()},
        "fp32_card_vs_cpu": xdev, "step_01": step, "kernels_b16": kernel_rows,
    }
    return total, kernel_rows, info


# -- phase 9: 03, 06 (both modes) and the legacy pair through the command line ---------------

#: (label, pipeline) of phase 9's command-line runs, each --epochs 1 at batch 16 in fp32.
P9_RUNS = (("03 dfc", "dfc"), ("06 fairehrclp", "fairehrclp"), ("legacy-eddi", "legacy-eddi"),
           ("legacy-behrt", "legacy-behrt"))
P9_MODULES = {"dfc": ("dfc", "run_dfc_experiment"),
              "fairehrclp": ("fairehr_clp", "run_fairehr_clp_experiment"),
              "legacy-eddi": ("legacy", "run_legacy_eddi_experiment"),
              "legacy-behrt": ("legacy", "run_legacy_behrt_experiment")}
#: The contrastive encoder's FFN: B 16 x 549 features (8784 rows, 48 past a multiple of
#: 128) x H 256 x F 512.
CLP_R, CLP_H, CLP_F = BASE_BATCH * N_LABS, 256, 512
#: Its products: (stage, layout, M, N, K, activation or gate).  The relu "nt" stage
#: drops at 0.1 and writes its aux; the ungated "nn" stage adds the residual.
CLP_STAGES = (
    ("06 w1 relu dropout aux", "nt", CLP_R, CLP_F, CLP_H, "relu"),
    ("06 w2", "nt", CLP_R, CLP_H, CLP_F, "none"),
    ("06 dh relu gate + colpart", "nn", CLP_R, CLP_F, CLP_H, "relu"),
    ("06 dx + resid", "nn", CLP_R, CLP_H, CLP_F, None),
    ("06 dW1 split-K", "tn", CLP_F, CLP_H, CLP_R, None),
    ("06 dW2 split-K", "tn", CLP_H, CLP_F, CLP_R, None),
)
#: Patients of the card-vs-CPU step of the models that launch no counted kernel: their
#: float64 step on the CPU sets the check's time, and the rule does not depend on the
#: batch.  The others keep BASE_BATCH (the timed steps all run at BASE_BATCH).
P9_CHECK_PATIENTS = {"03": 4, "legacy-behrt": 4, "EDDIFusionModel": 4}
#: Phase 9's timed train steps per model (CUDA-event median; phase 8 times 20).
P9_TIMED_STEPS = 5
#: The sequence BEHRT's geometry for its card step: about the vocabulary a 2048-subject
#: cohort gives, S 8 (up to 4 admissions).
SEQ_GEO = dict(num_diseases=5120, num_ages=76, num_admission_locs=19, num_discharge_locs=19,
               num_genders=2, num_ethnicities=5, num_insurances=5)


def legacy_predicted_launches(tables, frame):
    """Per run, the launches of every counted kernel and the split, worked
    out before the runs: 03, 06 and legacy-behrt launch none of #1-#4 (BERTs
    at one token or S 8, text at 128); legacy-eddi two lab layers per batch of
    every train step, validation and test pass; 06's contrastive encoder #2
    and the attention glue in each of its two layers for each of the two
    views per batch (the attention plain at 549 features), #4 and the glue's
    backward per train step; legacy-behrt's 12 BERT layers the glue and its
    backward per train step (train mode at S > 1 only)."""
    from fairmultimodal_torch.data.featurize import assemble_features
    from fairmultimodal_torch.pipelines.common import make_split
    from fairmultimodal_torch.pipelines.legacy import LEGACY_TASKS, prepare_admission_sequences

    notes = assemble_features(*tables)
    era = assemble_features(*tables, label_columns=LEGACY_TASKS)
    seq_labels = prepare_admission_sequences(frame)[1]
    splits = {"dfc": make_split(notes.labels, 0.20, 0.05, 42, method="skmultilearn"),
              "fairehrclp": make_split(notes.labels, 0.20, 0.05, 42, method="iterstrat"),
              "legacy-eddi": make_split(era.labels, 0.20, 0.05, 42),
              "legacy-behrt": make_split(seq_labels, 0.20, 0.05, 42)}
    splits["06 contrastive"] = splits["fairehrclp"]
    want = {}
    for name, split in splits.items():
        nb = {k: -(-len(v) // BASE_BATCH) for k, v in split.items()}
        every, train = nb["train"] + nb["val"] + nb["test"], nb["train"]
        want[name] = {k: 0 for k in ("fused_attention_block_ln", "fused_ffn_ln",
                                     "fused_attention_block_ln_bwd", "fused_ffn_ln_bwd",
                                     "glue", "glue_bwd")}
        if name == "legacy-eddi":
            want[name].update(fused_attention_block_ln=2 * every, fused_ffn_ln=2 * every,
                              fused_attention_block_ln_bwd=2 * train,
                              fused_ffn_ln_bwd=2 * train)
        elif name == "06 contrastive":
            want[name].update(fused_ffn_ln=4 * every, glue=4 * every,
                              fused_ffn_ln_bwd=4 * train, glue_bwd=4 * train)
        elif name == "legacy-behrt":
            want[name].update(glue=12 * train, glue_bwd=12 * train)
    return want, splits, notes


class _EDDIHeads(torch.nn.Module):
    """08's bare ``EDDIFusionModel`` over three embeddings of the batch, its
    nine logits averaged per task: the trainable form of a model no
    pipeline trains."""

    def __init__(self, dtype):
        super().__init__()
        from fairmultimodal_torch.models.fusion import EDDIFusionModel

        self.heads = EDDIFusionModel(768, 768, 768, dtype=dtype)

    def forward(self, batch, generator=None):
        out = self.heads(batch["demo_embedding"], batch["lab_embedding"],
                         batch["text_embedding"])
        return {"logits": torch.cat([sum(out[f"{t}_{m}"] for m in ("demo", "lab", "text")) / 3
                                     for t in self.heads.TASKS], dim=-1)}


def _p9_batch(name, n=BASE_BATCH, seed=8):
    """Host arrays of ``n`` patients for one new model's train step."""
    rng = np.random.default_rng(seed)
    a = synthetic_cohort(rng, n)
    if name == "legacy-behrt":
        lengths = rng.integers(1, 5, n)
        live = np.arange(8)[None, :] < lengths[:, None]
        inputs = {"disease_ids": np.where(live, rng.integers(1, SEQ_GEO["num_diseases"],
                                                             (n, 8)), 0)}
        for key, hi in (("age_ids", 76), ("segment_ids", 2), ("adm_loc_ids", 19),
                        ("disch_loc_ids", 19), ("gender_ids", 2), ("ethnicity_ids", 5),
                        ("insurance_ids", 5)):
            inputs[key] = np.where(live, rng.integers(0, hi, (n, 8)), 0)
        inputs = {k: v.astype(np.int32) for k, v in inputs.items()}
    else:
        inputs = {k: v for k, v in a.items() if k != "labels"}
        inputs.update({k: np.zeros(n, np.int32) for k in BASE_EXTRA_KEYS})
        inputs["demo_features"] = np.stack([a[k] for k in ("age_ids", "gender_ids",
                                                           "ethnicity_ids", "insurance_ids")],
                                           axis=1).astype(np.float32)
        inputs["demo_features_syn"] = inputs["demo_features"] + 0.05 * rng.standard_normal(
            (n, 4)).astype(np.float32)
        inputs["lab_features_syn"] = a["lab_features"] + 0.01 * rng.standard_normal(
            a["lab_features"].shape).astype(np.float32)
        inputs["demo_embedding"], inputs["lab_embedding"] = (
            rng.normal(0, 1, (n, 768)).astype(np.float32) for _ in range(2))
    labels = a["labels"][:, :2] if name == "legacy-eddi" else a["labels"]
    return {"model_inputs": inputs, "labels": labels, "weight": np.ones(n, np.float32)}


def _p9_models():
    """(name, model factory(dtype), train config, loss_extras) of the new
    models at full width, for the card-vs-CPU steps and the timed steps."""
    from fairmultimodal_torch.models.fairehr import FairEHRCLP, contrastive_loss
    from fairmultimodal_torch.models.legacy import BEHRTSequence, LegacyEDDIFull
    from fairmultimodal_torch.pipelines import (DfCPipelineConfig, FairEHRCLPPipelineConfig,
                                                LegacyBEHRTPipelineConfig,
                                                LegacyEDDIPipelineConfig)
    from fairmultimodal_torch.pipelines.dfc import DfCBatchModel

    clp = FairEHRCLPPipelineConfig()

    def extras(model, out, batch):
        return clp.contrastive_weight * contrastive_loss(out["e_adj"], out["e_adj_syn"],
                                                         tau=clp.tau, weight=batch["weight"])

    return (
        ("03", lambda dt: DfCBatchModel(dtype=dt), DfCPipelineConfig().train, None),
        ("06", lambda dt: FairEHRCLP(dtype=dt), clp.train, extras),
        ("legacy-eddi", lambda dt: LegacyEDDIFull(4, 2, 5, 6, N_LABS, dtype=dt),
         LegacyEDDIPipelineConfig().train, None),
        ("legacy-behrt", lambda dt: BEHRTSequence(**SEQ_GEO, dtype=dt),
         LegacyBEHRTPipelineConfig().train, None),
        ("EDDIFusionModel", _EDDIHeads, DfCPipelineConfig().train, None),
    )


def clp_kernel_rows(fab, ffn, _build):
    """#2 / #4 at 06's contrastive encoder shape (R 8784 x H 256 x F 512,
    relu, dropout 0.1) in fp32 and bf16: forward and backward against the
    plain versions (fp32: forward within FP32_TOL absolute, each grad within
    TRAIN_FP32_TOL of its max-abs; bf16: phase 3b's limits), the backward
    run twice for the same bits, timed beside the plain version, one library
    composition and the bound.  Then each GEMM stage of the path at that
    shape alone, the ragged last 48-row block included: fp32 against
    float64, bf16 against fp32 (phase 3c's limits)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {"fused_ffn_ln": {}, "fused_ffn_ln_bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        peak = FP32_PEAK if dtype == torch.float32 else BF16_PEAK
        f_err = ffn_train_check(ffn, _build, gen, dtype, 0.1, R=CLP_R, H=CLP_H, F=CLP_F,
                                timed=True, peak=peak)
        out_err = f_err["errors"]["out"]["max_abs_err"]
        if dtype == torch.float32 and not out_err <= FP32_TOL:
            raise AssertionError(f"#2 at R{CLP_R} H{CLP_H} F{CLP_F} fp32: forward max abs "
                                 f"{out_err} > {FP32_TOL}")
        if not f_err["deterministic"]:
            raise AssertionError(f"#4 at R{CLP_R} {tag}: two backward runs differ")
        rows["fused_ffn_ln"][tag], rows["fused_ffn_ln_bwd"][tag] = ffn_kernel_rows(
            ffn, gen, CLP_R, CLP_H, CLP_F, 0.1, 1e-5, dtype, f_err, peak)
        rows["fused_ffn_ln_bwd"][tag]["errors"] = f_err["errors"]
        torch.cuda.empty_cache()
    stages = []
    for name, layout, M, N, K, act in CLP_STAGES:
        relu = act == "relu"
        if layout == "nt":
            rate = 0.1 if relu else 0.0
            stages += [f32_gemm_check(_build, fab, gen, name, layout, M, N, K, act, rate, relu,
                                      False),
                       nt_gemm_check(_build, gen, name, M, N, K, act, rate, relu, False, False)]
        else:
            resid = layout == "nn" and not relu
            stages += [f32_gemm_check(_build, fab, gen, name, layout, M, N, K, act, resid, False,
                                      False),
                       nn_tn_gemm_check(_build, fab, gen, name, layout, M, N, K, act, resid,
                                        False)]
    for row in stages:
        log(f"[legacy] 06 GEMM stage: {json.dumps(row)}")
    for name, row in rows.items():
        log(f"[legacy] kernel {name} at R{CLP_R} H{CLP_H} F{CLP_F}: {json.dumps(row)}")
    return rows, stages


def legacy_phase(flash, fab, ffn, addnorm, _build):
    """03, 06, legacy-eddi and legacy-behrt through ``cli.main`` in-process on
    the card at full width in fp32, batch 16, 1 epoch (phase 7's cohort and
    snapshot; legacy-behrt on ``make_admission_frame(2048)``), and 06's
    contrastive mode through ``run_fairehr_clp_experiment``, with every
    counted kernel's launches predicted before the runs; then one fp32 step
    of each new model card against CPU and float64, each step timed and
    profiled (legacy-behrt also without dropout), and #2 / #4 at 06's shape."""
    import contextlib
    import dataclasses
    import gc
    import importlib
    import io
    import os
    import shutil

    from fairmultimodal_torch.data.synthetic import make_admission_frame, make_common_frames
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.pipelines import FairEHRCLPPipelineConfig
    from fairmultimodal_torch.train.simple import MultitaskTrainer

    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase9")
    env_keys = ("HF_HUB_CACHE", "FMTPU_TEXT_CACHE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    modules = {name: importlib.import_module(f"fairmultimodal_torch.pipelines.{mod}")
               for name, (mod, _) in P9_MODULES.items()}
    originals = {name: getattr(modules[name], fn) for name, (_, fn) in P9_MODULES.items()}
    results = []

    def recording(name):
        def run(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            results.append(out)
            return out
        return run

    def timed_run(label, fn):
        _reset_counts(fab, ffn, addnorm)
        flash.launches = flash.bwd_launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts(flash, fab, ffn, addnorm)
        if rc != 0:
            raise AssertionError(f"{label}: exit code {rc}")
        out = results.pop()
        idx = out["prep"].idx if "prep" in out else out["splits"]
        out = {"idx": idx, **{k: out[k] for k in ("metrics", "timings", "history")}}
        tail = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith(("[Epoch", "Train size", "After filtering", "Patients:",
                                  "Overall Combined"))]
        runs[label] = {"wall_s": wall, "launches": counts, "out": out}
        log(f"[legacy] {label}: {wall:.2f} s, timings {json.dumps(out['timings'])}\n"
            "[legacy]   " + "\n[legacy]   ".join(tail))
        gc.collect()
        torch.cuda.empty_cache()

    runs, phase_s, t_phase = {}, {}, time.perf_counter()
    try:
        write_hf_snapshot(os.path.join(root, "hub"))
        os.environ["HF_HUB_CACHE"] = os.path.join(root, "hub")
        os.environ["FMTPU_TEXT_CACHE"] = os.path.join(root, "text_cache")
        tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
        frame = make_admission_frame(CLI_PATIENTS, seed=42)
        want, splits, notes = legacy_predicted_launches(tables, frame)
        log(f"[legacy] predicted launches {json.dumps(want)}; splits "
            f"{ {k: [len(v[s]) for s in ('train', 'val', 'test')] for k, v in splits.items()} }")
        for name, (_, fn) in P9_MODULES.items():
            setattr(modules[name], fn, recording(name))
        common = ["--synthetic", str(CLI_PATIENTS), "--synthetic_labs", str(CLI_LABS),
                  "--epochs", "1", "--require_hf_weights", "--text_cache",
                  os.path.join(root, "text_cache")]
        for label, name in P9_RUNS:
            argv = [name, "--out_dir", os.path.join(root, name)] + (
                ["--synthetic", str(CLI_PATIENTS), "--epochs", "1"]
                if name == "legacy-behrt" else common)
            timed_run(label, lambda: cli.main(argv))
        cfg = FairEHRCLPPipelineConfig(contrastive=True)
        cfg.train.num_epochs = 1
        timed_run("06 contrastive", lambda: 0 if modules["fairehrclp"].run_fairehr_clp_experiment(
            *tables, cfg, verbose=True) else 1)
    finally:
        for name, (_, fn) in P9_MODULES.items():
            setattr(modules[name], fn, originals[name])
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)

    phase_s["runs"] = time.perf_counter() - t_phase
    key = {"03 dfc": "dfc", "06 fairehrclp": "fairehrclp", "legacy-eddi": "legacy-eddi",
           "legacy-behrt": "legacy-behrt", "06 contrastive": "06 contrastive"}
    for label, r in runs.items():
        name, out = key[label], r["out"]
        wanted = {k: 0 for k in r["launches"]}
        wanted.update(want[name])
        if r["launches"] != wanted:
            raise AssertionError(f"{label}: launches {r['launches']}, predicted {wanted}")
        for task, m in out["metrics"].items():
            if not (np.isfinite(m["aucroc"]) and np.isfinite(m["auprc"])):
                raise AssertionError(f"{label} {task}: metrics {m}")
        for k, v in splits[name].items():
            if not np.array_equal(out["idx"][k], v):
                raise AssertionError(f"{label}: {k} split differs from the one worked out "
                                     "beforehand")
        r["train_patients_per_fit_s"] = len(splits[name]["train"]) / out["timings"]["train"]
    if list(runs["legacy-eddi"]["out"]["metrics"]) != ["mortality", "readmission"]:
        raise AssertionError(f"legacy-eddi tasks {list(runs['legacy-eddi']['out']['metrics'])}")

    # One fp32 step of each new model, card against CPU and float64: phase 8's rule
    # (legacy-eddi's lab layers replayed and held by lab_grad_rule, as 09's are).
    xdev, steps = {}, {}
    for name, factory, cfg, extras in _p9_models():
        t0 = time.perf_counter()
        batch = _p9_batch(name)
        pw = POS_WEIGHT[:2] if name == "legacy-eddi" else POS_WEIGHT
        init = init_params(factory(torch.float32), seed=0)     # one init per model
        kw = dict(batch=_p9_batch(name, P9_CHECK_PATIENTS.get(name, BASE_BATCH)),
                  loss_extras=extras, pos_weight=pw, init=init)
        taps = {who: {} for who in ("card", "cpu", "f64")}

        def tap(who):
            return _lab_layer_taps(taps[who]) if name in REPLAY_MODELS else None

        try:
            card = baseline_fp32_step(name, factory, (), cfg, "cuda", prepare=tap("card"), **kw)
            taps["card"].pop("restore", lambda: None)()
            cpu = baseline_fp32_step(name, factory, (), cfg, "cpu", prepare=tap("cpu"), **kw)
            taps["cpu"].pop("restore", lambda: None)()
            _, ref = baseline_fp32_step(name, factory, (), cfg, "cpu", torch.float64,
                                        prepare=tap("f64"), **kw)
        finally:
            for t in taps.values():
                t.pop("restore", lambda: None)()
        loss_rel, worst, grad_rel = compare_steps(card, cpu)
        card_ref, cpu_ref = grad_errors(card[1], ref), grad_errors(cpu[1], ref)
        margin = {n: (card_ref[n] - cpu_ref[n]) / XDEV_GRAD_TOL for n in card_ref}
        tight = max(margin, key=margin.get)
        xdev[name] = {"loss_card": card[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
                      "worst_grad": worst, "worst_grad_rel": grad_rel,
                      "tightest_vs_f64": {"leaf": tight, "share_of_limit": margin[tight],
                                          "card_vs_f64": card_ref[tight],
                                          "cpu_fp32_vs_f64": cpu_ref[tight]}}
        if name in REPLAY_MODELS:
            margin = replayed_shares(fab, ffn, _build, factory, taps, card, cpu, ref, xdev[name])
        del taps
        xdev[name]["check_s"] = time.perf_counter() - t0
        log(f"[legacy] fp32 step {name} card vs CPU and float64: {json.dumps(xdev[name])}")
        over = sorted(n for n, m in margin.items() if not m <= 1.0)
        if not loss_rel <= XDEV_LOSS_TOL or over:
            raise AssertionError(f"{name} fp32 card vs CPU: loss rel {loss_rel}, grads over "
                                 f"the limit {over} {xdev[name]}")
        # The train step at batch 16 in fp32 on the card, timed and profiled.
        t0 = time.perf_counter()
        trainer = MultitaskTrainer(init, dataclasses.replace(cfg, seed=5), pw, device="cuda",
                                   loss_extras=extras)
        dev_batch = to_device(batch, trainer.device)
        steps[name] = {"timed": time_train_step(trainer, dev_batch, steps=P9_TIMED_STEPS),
                       "profile": profile_train_step(trainer, dev_batch, steps=1)}
        if name == "legacy-behrt":       # the int64 Philox dropout's share (ROADMAP queue 3)
            trainer.config.deterministic_forward = True
            steps[name]["no_dropout"] = time_train_step(trainer, dev_batch,
                                                        steps=P9_TIMED_STEPS)
            on, off = (steps[name][k]["train_step_ms"] for k in ("timed", "no_dropout"))
            steps[name]["dropout_share"] = (on - off) / on
        steps[name]["step_s"] = time.perf_counter() - t0
        log(f"[legacy] train step {name} fp32 B{BASE_BATCH}: {json.dumps(steps[name])}")
        del trainer, dev_batch
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    clp_rows, clp_stages = clp_kernel_rows(fab, ffn, _build)
    phase_s["clp_kernels"] = time.perf_counter() - t0
    phase_s["steps"] = t0 - t_phase - phase_s["runs"]
    log(f"[legacy] phase 9 seconds by part: {json.dumps(phase_s)}")
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in ("fused_attention_block_ln", "fused_ffn_ln",
                       "fused_attention_block_ln_bwd", "fused_ffn_ln_bwd")}
    info = {
        "launches_predicted": want, "launches_total": total,
        "runs": {label: {"wall_s": r["wall_s"], "timings_s": r["out"]["timings"],
                         "train_patients_per_fit_s": r["train_patients_per_fit_s"],
                         "history": r["out"]["history"],
                         "splits": [len(splits[key[label]][k])
                                    for k in ("train", "val", "test")],
                         "launches": r["launches"]}
                 for label, r in runs.items()},
        "fp32_card_vs_cpu": xdev, "train_steps_fp32": steps, "seconds_by_part": phase_s,
        "clp_kernels": clp_rows,
        "clp_stages": [{k: row.get(k) for k in ("stage", "layout", "M", "N", "K", "errors",
                                                 "tile", "splits", "deterministic")}
                       for row in clp_stages],
    }
    return total, clp_rows, info


# -- phase 10: 04 adv_debias (pipelines/adv_debias.py over train/adversarial.py) -------------

#: Phase 10's stage-2 grid: two points of REFERENCE_GRID's values (the two widths).
ADV_GRID = {"learning_rate": [1e-4], "num_iters": [200], "num_nodes": [64, 128],
            "num_nodes_adv": [32], "dropout_rate": [0.3], "alpha": [1]}
#: ``metrics.csv``'s columns as the JAX pipeline writes them: the config's, then the metrics'.
ADV_COLUMNS = ["learning_rate", "num_iters", "num_nodes", "num_nodes_adv", "dropout_rate",
               "alpha", "adversarial", "seed", "accuracy", "recall", "precision",
               "specificity", "PPV", "NPV", "f1", "auroc", "recall_gap_z"]
#: A reloaded predictor against the run's validation probabilities: the same fp32
#: network on the same rows, so equal but for the launch order of one card.
ADV_RELOAD_TOL = 1e-6
#: Card against CPU over 20 iterations at dropout 0 (phase 8's rule): each parameter's and
#: the loss curve's error against float64 may exceed the CPU fp32's own by 1e-4 of its
#: max-abs.
ADV_XDEV_TOL = 1e-4
ADV_TIMED, ADV_WARMUP, ADV_PROFILED = 200, 20, 10


def adv_expected(tables):
    """The split and stage 2's row counts worked out before the run:
    iterstrat's split of the featurized cohort, then the numpy matching and
    resampling of the train split's mortality column against ethnicity > 0.
    Returns (split, counts, bundle)."""
    from fairmultimodal_torch.data.featurize import assemble_features
    from fairmultimodal_torch.pipelines.common import make_split
    from fairmultimodal_torch.train.adversarial import match_case_control, resample_smoteenn

    bundle = assemble_features(*tables)
    split = make_split(bundle.labels, 0.20, 0.05, 42, method="iterstrat")
    tr = split["train"]
    y = bundle.labels[tr, 0].astype(np.float32)
    z = (bundle.ethnicity_codes[tr] > 0).astype(np.float32)
    keep = match_case_control(y, 20)
    resampled = resample_smoteenn(bundle.labs_raw[tr][keep], y[keep], z[keep])[1]
    return split, {"matched": len(keep), "resampled": len(resampled)}, bundle


def adv_defined(yv, zv):
    """The stage-2 metrics that are defined on this validation split: AUROC
    with both classes in ``yv``, the recall gap with positives in both z groups."""
    zb = np.asarray(zv) > 0
    undefined = set()
    if len(np.unique(yv)) < 2:
        undefined.add("auroc")
    if not ((yv[zb] == 1).any() and (yv[~zb] == 1).any()):
        undefined.add("recall_gap_z")
    return [k for k in ADV_COLUMNS[8:] if k not in undefined]


def adv_card_vs_cpu(data):
    """``train_adversarial`` for 20 iterations at dropout 0 on the card and on
    the CPU from the same initial weights, held against the same iterations in
    float64 on the CPU (``adversarial_step``): per parameter and for the loss
    curve, (card error - CPU fp32 error) / max-abs / ADV_XDEV_TOL."""
    from fairmultimodal_torch.train import adversarial as adv

    cfg = adv.AdvConfig(learning_rate=1e-4, num_iters=20, num_nodes=64, num_nodes_adv=32,
                        dropout_rate=0.0, alpha=1)
    card, cpu = (adv.train_adversarial(*data, cfg, verbose=False, log_every=1, device=d)
                 for d in ("cuda", "cpu"))
    pred, net = adv.init_adv_models(data[0].shape[1], cfg)
    pred, net = pred.double(), net.double()
    opts = [torch.optim.Adam(m.parameters(), lr=cfg.learning_rate) for m in (pred, net)]
    X, y, z = (torch.as_tensor(np.asarray(a), dtype=torch.float64) for a in data[:3])
    curve = [float(adv.adversarial_step(pred, net, opts, X, y.reshape(-1, 1), z.reshape(-1, 1),
                                        cfg, None)) for _ in range(cfg.num_iters)]

    def share(got, want, ref):
        return float((np.abs(got - ref).max() - np.abs(want - ref).max())
                     / np.abs(ref).max() / ADV_XDEV_TOL)

    ref_curve = np.asarray(curve)
    shares = {"loss_curve": share(np.asarray(card["train_curve"]), np.asarray(cpu["train_curve"]),
                                  ref_curve)}
    for who, ref in (("predictor", pred), ("adversary", net)):
        for name, p in ref.named_parameters():
            shares[f"{who}.{name}"] = share(
                card[who].get_parameter(name).detach().cpu().double().numpy(),
                cpu[who].get_parameter(name).detach().double().numpy(), p.detach().numpy())
    return shares


def time_adv_iterations(data, num_nodes, rate, logdir):
    """One stage-2 iteration (``adversarial_step``) at ``num_nodes`` x 32 on
    the card: the median of ADV_TIMED after ADV_WARMUP with ``utils/profiling``'s
    Timer (the loss waited for), then ADV_PROFILED iterations under
    ``profile_to``: device busy ms (``hlo_self_times``), the idle share of
    the timed median and of the profiled window (the profiler slows the
    host), kernel launches per iteration and the largest kernels."""
    from fairmultimodal_torch.train import adversarial as adv
    from fairmultimodal_torch.utils.profiling import Timer, hlo_self_times, profile_to
    from fairmultimodal_torch.utils.rng import make_generator

    cfg = adv.AdvConfig(num_nodes=num_nodes, num_nodes_adv=32, dropout_rate=rate)
    pred, net = (m.to("cuda") for m in adv.init_adv_models(data[0].shape[1], cfg))
    opts = [torch.optim.Adam(m.parameters(), lr=cfg.learning_rate) for m in (pred, net)]
    X, y, z = (torch.as_tensor(np.asarray(a, np.float32), device="cuda") for a in data[:3])
    y, z, gen = y.reshape(-1, 1), z.reshape(-1, 1), make_generator(cfg.seed + 1)

    def step():
        return adv.adversarial_step(pred, net, opts, X, y, z, cfg, gen)

    for _ in range(ADV_WARMUP):
        step()
    times = []
    for _ in range(ADV_TIMED):
        with Timer() as timer:
            times.append(1e3 * timer.stop(step()))
    with profile_to(logdir) as prof:
        t0 = time.perf_counter()
        for _ in range(ADV_PROFILED):
            loss = step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / ADV_PROFILED
    by_category, by_op = hlo_self_times(logdir)
    busy_ms = sum(by_category.values()) / 1e3 / ADV_PROFILED
    launches = sum(e.count for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    return {"ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / statistics.median(times),
            "idle_share_profiled": 1.0 - busy_ms / wall_ms,
            "launches_per_iter": launches / ADV_PROFILED,
            "by_category_ms": {k: v / 1e3 / ADV_PROFILED for k, v in by_category.items()},
            "top_kernels_ms": {k[:90]: v / 1e3 / ADV_PROFILED for k, v in top},
            "loss_finite": bool(torch.isfinite(loss))}


def adv_debias_phase(flash, fab, ffn, addnorm):
    """04 through ``run_adv_debias_experiment`` on the card at full width in
    fp32 (phase 7's cohort and snapshot, batch 16, 1 epoch, stage 2 on
    ADV_GRID), with every counted kernel's launches read around it (0, as
    worked out: 07's model, text at 128, two MLPs); the command line's
    ``advdebias --tiny``; stage 2 card against CPU and float64; one stage-2
    iteration timed and profiled at both widths with and without dropout, and
    what the full REFERENCE_GRID would take at those rates."""
    import contextlib
    import csv
    import importlib
    import io
    import itertools
    import os
    import shutil

    from fairmultimodal_torch.data.synthetic import make_common_frames
    from fairmultimodal_torch.models.text import TextEncoder
    from fairmultimodal_torch.pipelines.adv_debias import (AdvDebiasPipelineConfig,
                                                           run_adv_debias_experiment)
    from fairmultimodal_torch.train import adversarial as adv
    from fairmultimodal_torch.utils.debug import check_finite_tree

    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase10")
    env_keys = ("HF_HUB_CACHE", "FMTPU_TEXT_CACHE")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    originals = adv.resample_smoteenn, adv.train_adversarial
    seen = {"resample": [], "train": []}

    def resample(X, y, z, seed=25):
        out = originals[0](X, y, z, seed)
        seen["resample"].append({"matched": len(y), "resampled": len(out[1])})
        return out

    def train(*args, **kwargs):
        out = originals[1](*args, **kwargs)
        seen["train"].append((args[:6], out))
        return out

    def counted(fn):
        _reset_counts(fab, ffn, addnorm)
        flash.launches = flash.bwd_launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _all_counts(flash, fab, ffn, addnorm), buf.getvalue()

    info, parts, t_phase = {}, {}, time.perf_counter()
    try:
        write_hf_snapshot(os.path.join(root, "hub"))
        os.environ["HF_HUB_CACHE"] = os.path.join(root, "hub")
        os.environ["FMTPU_TEXT_CACHE"] = os.path.join(root, "text_cache")
        tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
        split, rows, bundle = adv_expected(tables)
        encoder = TextEncoder.from_pretrained(require_weights=True, device="cuda")
        cfg = AdvDebiasPipelineConfig(stage2_grid=ADV_GRID, out_dir=os.path.join(root, "run"))
        cfg.train.num_epochs = 1
        parts["setup"] = time.perf_counter() - t_phase
        adv.resample_smoteenn, adv.train_adversarial = resample, train
        try:
            out, wall, counts, stdout = counted(
                lambda: run_adv_debias_experiment(*tables, cfg, text_encoder=encoder))
        finally:
            adv.resample_smoteenn, adv.train_adversarial = originals
        parts["run"] = wall
        log("[adv] " + "\n[adv] ".join(ln for ln in stdout.splitlines() if ln.startswith(
            ("After filtering", "Train size", "[Epoch", "Iteration:", "Saved", "Evaluation"))))

        # The run's checks.
        if any(counts.values()):
            raise AssertionError(f"04: launches {counts}, worked out as 0 for every kernel")
        for k, v in split.items():
            if not np.array_equal(out["prep"].idx[k], v):
                raise AssertionError(f"04: the {k} split differs from iterstrat's")
        if seen["resample"] != [rows]:
            raise AssertionError(f"04: stage-2 rows {seen['resample']}, worked out {rows}")
        for task, m in out["metrics"].items():
            if not (np.isfinite(m["aucroc"]) and np.isfinite(m["auprc"])):
                raise AssertionError(f"04 stage 1 {task}: metrics {m}")
        va = split["val"]
        defined = adv_defined(bundle.labels[va, 0], bundle.ethnicity_codes[va])
        run_dir, reload_err = cfg.out_dir, {}
        for r, (args, trained) in zip(out["stage2"], seen["train"]):
            bad = [k for k in defined if not np.isfinite(r["metrics"][k])]
            if bad:
                raise AssertionError(f"04 stage 2 {r['config']}: {bad} not finite {r['metrics']}")
            tag = adv.params_tostring(adv.AdvConfig(**r["config"]))
            for path in (f"model/model-basic_{tag}.npz", f"adv/model-adv_{tag}.npz"):
                if not os.path.isfile(os.path.join(run_dir, path)):
                    raise AssertionError(f"04: {path} missing")
            module, _ = adv.load_adv_artifact(os.path.join(run_dir, "model",
                                                           f"model-basic_{tag}.npz"))
            with torch.no_grad():
                yhat = torch.sigmoid(module(torch.as_tensor(args[3], device="cuda"))).cpu()
            reload_err[tag] = float((yhat - torch.from_numpy(trained["yhat_valid"])).abs().max())
            nonfinite = (check_finite_tree(r["predictor"], "predictor")
                         + check_finite_tree(r["adversary"], "adversary"))
            if reload_err[tag] > ADV_RELOAD_TOL or nonfinite:
                raise AssertionError(f"04 {tag}: reloaded predictor {reload_err[tag]}, "
                                     f"non-finite {nonfinite}")
        for path in ("model/model-basic_final.npz", "adv/model-adv_final.npz", "metrics"):
            if not os.path.exists(os.path.join(run_dir, path)):
                raise AssertionError(f"04: {path} missing")
        with open(os.path.join(run_dir, "metrics.csv"), newline="") as f:
            header, *csv_rows = list(csv.reader(f))
        if header != ADV_COLUMNS or len(csv_rows) != 2 or len(out["stage2"]) != 2:
            raise AssertionError(f"04 metrics.csv: {header}, {len(csv_rows)} rows")
        info["run"] = {"wall_s": wall, "timings_s": out["timings"], "launches": counts,
                       "history": out["history"],
                       "splits": [len(split[k]) for k in ("train", "val", "test")],
                       "stage2_rows": rows, "reload_max_abs": reload_err,
                       "stage2": [{"config": r["config"], "metrics": r["metrics"]}
                                  for r in out["stage2"]]}
        log(f"[adv] run: {json.dumps(info['run'])}")

        # The command line's branch, in-process.
        t0 = time.perf_counter()
        cli_dir = os.path.join(root, "cli")
        rc, cli_wall, cli_counts, cli_out = counted(lambda: cli.main(
            ["advdebias", "--tiny", "--synthetic", "64", "--require_hf_weights",
             "--text_cache", os.path.join(root, "text_cache"), "--out_dir", cli_dir]))
        written = sorted(os.path.relpath(os.path.join(d, f), cli_dir)
                         for d, _, files in os.walk(cli_dir) for f in files)
        if rc != 0 or any(cli_counts.values()) or "metrics.csv" not in written or sum(
                p.endswith(".npz") for p in written) != 4 or "Iteration: 0," not in cli_out:
            raise AssertionError(f"advdebias --tiny: rc {rc}, launches {cli_counts}, "
                                 f"files {written}")
        info["cli"] = {"wall_s": cli_wall, "launches": cli_counts, "files": written}
        parts["cli"] = time.perf_counter() - t0

        # Stage 2 card against CPU and float64 on the run's first point's rows.
        t0 = time.perf_counter()
        data = seen["train"][0][0]
        shares, _, xcounts, _ = counted(lambda: adv_card_vs_cpu(data))
        tight = max(shares, key=shares.get)
        info["card_vs_cpu"] = {"rows": len(data[1]), "features": data[0].shape[1],
                               "launches": xcounts, "tightest": tight,
                               "share_of_limit": shares[tight], "shares": shares}
        log(f"[adv] stage 2 card vs CPU and float64: {json.dumps(info['card_vs_cpu'])}")
        over = sorted(k for k, v in shares.items() if not v <= 1.0)
        if over or any(xcounts.values()):
            raise AssertionError(f"stage 2 card vs CPU: over the limit {over}, "
                                 f"launches {xcounts}")
        parts["card_vs_cpu"] = time.perf_counter() - t0

        # One stage-2 iteration timed and profiled; the full reference grid at these rates.
        t0 = time.perf_counter()
        timed = {}
        for nodes, rate in itertools.product((64, 128), (0.3, 0.0)):
            row = time_adv_iterations(data, nodes, rate, os.path.join(
                root, "trace", f"{nodes}_{rate}"))
            if not row["loss_finite"]:
                raise AssertionError(f"stage-2 iteration {nodes} dropout {rate}: loss not finite")
            timed[f"nodes{nodes}_dropout{rate}"] = row
            log(f"[adv] stage-2 iteration {nodes} x 32, dropout {rate}, {len(data[1])} rows: "
                f"{json.dumps(row)}")
        grid = adv.REFERENCE_GRID
        points = [dict(zip(grid, v)) for v in itertools.product(*grid.values())]
        info["iteration"] = timed
        info["dropout_share"] = {n: 1.0 - timed[f"nodes{n}_dropout0.0"]["ms"]
                                 / timed[f"nodes{n}_dropout0.3"]["ms"] for n in (64, 128)}
        info["reference_grid_estimate_s"] = sum(
            p["num_iters"] * timed[f"nodes{p['num_nodes']}_dropout0.3"]["ms"]
            for p in points) / 1e3
        info["reference_grid_iterations"] = sum(p["num_iters"] for p in points)
        parts["timing"] = time.perf_counter() - t0
    finally:
        adv.resample_smoteenn, adv.train_adversarial = originals
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    info["seconds_by_part"] = parts
    log(f"[adv] phase 10 seconds by part: {json.dumps(parts)}; full REFERENCE_GRID at these "
        f"rates {info['reference_grid_estimate_s']:.1f} s")
    return counts, info

# -- phase 11: the MIMIC-III ETL (run_etl, python -m fairmultimodal_torch.cli data) ---------

ETL_FILES = ("final_structured_dataset.csv", "final_structured_with_feature_set_C_24h_2h_bins.csv",
             "unstructured_with_demographics.csv", "final_structured_common.csv",
             "final_unstructured_common.csv")
ETL_SUBJECTS = 400
#: A fortieth of ETL_BENCH_r05.log's CHARTEVENTS rows (20M), cut for the run's time limit
#: (at 2M, whole runs of this script on slower H100 hosts took 1133-1176 s of the 1200).
ETL_SCALED = dict(n_subjects=3000, chartevents_rows=500_000)
#: Floats within 1e-12 of their column's max-abs: the card's segment sums and the CPU's
#: may add in another order (the JAX native path already differs by 7e-16).
ETL_TOL = 1e-12

#: One ``python -m fairmultimodal_torch.cli data`` run in its own process, under the
#: profiler: its stdout, then a JSON line with its wall time, the card's busy time and
#: launches (``hlo_self_times`` / ``key_averages``), its peak device memory, its RSS
#: before the run (imports and the CUDA context) and its peak RSS, sampled from
#: ``/proc/self/statm`` every 10 ms (``ru_maxrss`` keeps the forking parent's peak across
#: ``exec``), and every counted kernel's launches.
ETL_CHILD = r"""
import json, os, sys, threading, time
import torch
import chip_smoke as c
from fairmultimodal_torch.cli.main import main
from fairmultimodal_torch.ops import dropout_add_layernorm as an, flash_attention as fl
from fairmultimodal_torch.ops import fused_attention_block as fab, fused_ffn as ffn
from fairmultimodal_torch.utils.profiling import hlo_self_times, profile_to
logdir, argv = sys.argv[1], sys.argv[2:]
cuda = "cpu" not in argv


def rss_gb():
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2 ** 30
    except (OSError, IndexError, ValueError):
        return float("nan")


peak, done = [0.0], threading.Event()


def sample():
    while not done.wait(0.01):
        peak[0] = max(peak[0], rss_gb())


if cuda:
    torch.zeros(1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
c._reset_counts(fab, ffn, an)
fl.launches = fl.bwd_launches = 0
rss0 = peak[0] = rss_gb()
sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
t0 = time.perf_counter()
with profile_to(logdir) as prof:
    rc = main(argv)
    if cuda:
        torch.cuda.synchronize()
wall = time.perf_counter() - t0
done.set()
sampler.join()
busy = sum(hlo_self_times(logdir)[0].values()) / 1e6 if cuda else None
print(json.dumps({
    "rc": rc, "wall_s": wall, "device_busy_s": busy,
    "device_launches": sum(e.count for e in prof.key_averages()
                           if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
    "peak_device_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    "peak_rss_gb": max(peak[0], rss_gb()),
    "rss_before_run_gb": rss0,
    "launches": c._all_counts(fl, fab, ffn, an)}))
"""


def etl_rule(want_dir, got_dir):
    """The ETL's CSV rule without pandas (the card has none): each file read
    by ``read_csv_table`` (pandas' typing) has the same columns in order,
    dtypes and rows; text, integers and bools equal and missing cells in the
    same places; floats within ETL_TOL of the column's max-abs.  Returns the
    largest float error relative to its column's max-abs, per file."""
    import os

    from fairmultimodal_torch.data.table import read_csv_table

    worst = {}
    for name in ETL_FILES:
        want = read_csv_table(os.path.join(want_dir, name))
        got = read_csv_table(os.path.join(got_dir, name))
        if list(got) != list(want) or len(next(iter(got.values()))) != len(
                next(iter(want.values()))):
            raise AssertionError(f"{name}: columns or rows differ")
        worst[name] = 0.0
        for col, w in want.items():
            g = got[col]
            if g.dtype != w.dtype:
                raise AssertionError(f"{name}:{col}: dtype {g.dtype} against {w.dtype}")
            if w.dtype.kind != "f":
                if g.tolist() != w.tolist():
                    raise AssertionError(f"{name}:{col}: values differ")
                continue
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                raise AssertionError(f"{name}:{col}: NaN cells differ")
            ok = ~np.isnan(w)
            if ok.any():
                err = float(np.abs(g[ok] - w[ok]).max()) / max(float(np.abs(w[ok]).max()), 1e-300)
                if err > ETL_TOL:
                    raise AssertionError(f"{name}:{col}: {err} of max-abs > {ETL_TOL}")
                worst[name] = max(worst[name], err)
    return worst


def _timing_lines(text):
    """The ``--timing`` lines: per table {path, rows, seconds, rows_per_s}, and
    the structured / unstructured phase seconds."""
    import re

    tables = {t: {"path": p, "rows": int(n.replace(",", "")), "seconds": float(sec),
                  "rows_per_s": int(n.replace(",", "")) / float(sec) if float(sec) else None}
              for t, p, n, sec in re.findall(
                  r"\[etl timing\] (\w+): (\w+) path, ([\d,]+) rows in ([\d.]+) s", text)}
    phases = re.search(r"structured phase: ([\d.]+) s, unstructured phase: ([\d.]+) s", text)
    return {"tables": tables, "structured_s": float(phases.group(1)),
            "unstructured_s": float(phases.group(2))}


def etl_cli_run(mimic_dir, out_dir, flag, device="cuda"):
    """``python -m fairmultimodal_torch.cli data --mimic_dir ... --timing
    --use_native <flag>`` in its own process under the profiler (ETL_CHILD):
    its wall time, the card's busy share, launches, peak device memory, peak
    RSS, counted kernels' launches and its ``--timing`` lines."""
    import os
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    argv = [sys.executable, "-c", ETL_CHILD, out_dir + "_trace", "data", "--mimic_dir",
            mimic_dir, "--out_dir", out_dir, "--timing", "--use_native", flag,
            "--device", device]
    proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=3000)
    if proc.returncode != 0:
        raise AssertionError(f"data --use_native {flag}: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    busy = child["device_busy_s"]
    return {**child, **_timing_lines(proc.stdout), "process_s": time.perf_counter() - t0,
            "device_share": None if busy is None else busy / child["wall_s"]}


def etl_bench(chartevents_rows=20_000_000, n_subjects=3000, device="cuda"):
    """``write_raw_mimic_scaled`` at ``ETL_BENCH_r05.log``'s volume, then
    ``etl_cli_run`` with the native scanners on and off, the two outputs
    held to each other by ``etl_rule``; prints and returns one JSON object
    with the card's ``nvidia-smi`` name and power limit.  Work files under
    ``build/etl_bench/``, removed at the end.

        python3 -c "import chip_smoke as c; c.etl_bench()"
    """
    import os
    import shutil
    import subprocess

    from fairmultimodal_torch.data.synthetic import write_raw_mimic_scaled

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "etl_bench")
    shutil.rmtree(root, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": smi, "chartevents_rows": chartevents_rows, "n_subjects": n_subjects}
    try:
        t0 = time.perf_counter()
        out["tables"] = write_raw_mimic_scaled(os.path.join(root, "raw"), n_subjects=n_subjects,
                                               chartevents_rows=chartevents_rows, verbose=False)
        out["write_s"] = time.perf_counter() - t0
        for flag in ("on", "off"):
            out[flag] = etl_cli_run(os.path.join(root, "raw"), os.path.join(root, flag), flag,
                                    device)
            log(f"[etl_bench] --use_native {flag}: {json.dumps(out[flag])}")
        out["native_vs_plain_max_err_of_max_abs"] = etl_rule(os.path.join(root, "off"),
                                                             os.path.join(root, "on"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    return out


def etl_phase(flash, fab, ffn, addnorm, device="cuda", scaled=ETL_SCALED):
    """The ETL on the card: ``write_raw_mimic(400)`` through ``run_etl`` on
    ``device`` against the port's own ``run_etl`` on the CPU by ``etl_rule``,
    native scanners on and off; a second run on ``device`` byte-identical to
    the first; ``cli.main(["data", "--synthetic", "40"])`` in-process (its
    five files, by the rule against the CPU); then ``write_raw_mimic_scaled``
    at ``scaled`` through ``python -m fairmultimodal_torch.cli data --timing
    --use_native on`` and ``off`` in their own processes (ETL_CHILD: per
    table rows/s, the card's busy share, peak device memory and RSS), the two
    paths held to each other by the rule.  Every counted kernel's launches
    are read around every run; all must be 0."""
    import contextlib
    import importlib
    import io
    import os
    import shutil

    from fairmultimodal_torch.data import native
    from fairmultimodal_torch.data.etl import run_etl
    from fairmultimodal_torch.data.synthetic import write_raw_mimic, write_raw_mimic_scaled

    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "phase11")
    shutil.rmtree(root, ignore_errors=True)
    total = {}

    def counted(fn):
        _reset_counts(fab, ffn, addnorm)
        flash.launches = flash.bwd_launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts(flash, fab, ffn, addnorm)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, wall, buf.getvalue()

    def path(*parts):
        return os.path.join(root, *parts)

    info, parts, t_phase = {}, {}, time.perf_counter()
    try:
        t0 = time.perf_counter()
        if not (native.available() and native.notes_available()):
            raise AssertionError("the native scanners did not build")
        parts["native_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_raw_mimic(path("raw400"), n_subjects=ETL_SUBJECTS, seed=0)
        parts["write_raw_mimic"] = time.perf_counter() - t0

        runs, t_runs = {}, time.perf_counter()
        for use_native in (True, False):
            tag = "native" if use_native else "plain"
            stats, wall, out = counted(lambda: run_etl(
                path("raw400"), path(f"{device}_{tag}"), use_native=use_native, timing=True,
                device=device))
            t_cpu = time.perf_counter()
            cpu_stats = run_etl(path("raw400"), path(f"cpu_{tag}"), use_native=use_native,
                                device="cpu")
            stats.pop("timings")
            if stats != cpu_stats:
                raise AssertionError(f"400 subjects, {tag}: stats {stats} against {cpu_stats}")
            runs[tag] = {"wall_s": wall, "cpu_wall_s": time.perf_counter() - t_cpu,
                         "timing": _timing_lines(out), "stats": stats,
                         "max_err_of_max_abs": etl_rule(path(f"cpu_{tag}"),
                                                        path(f"{device}_{tag}"))}
        _, wall, _ = counted(lambda: run_etl(path("raw400"), path(f"{device}_again"),
                                             use_native=True, device=device))
        for name in ETL_FILES:
            with open(path(f"{device}_native", name), "rb") as a, \
                    open(path(f"{device}_again", name), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"two runs on {device}: {name} differs")
        runs["native_again"] = {"wall_s": wall, "byte_identical": True}
        info["subjects400"] = runs
        log(f"[etl] 400 subjects on {device} against the CPU: {json.dumps(runs)}")
        parts["subjects400"] = time.perf_counter() - t_runs

        t0 = time.perf_counter()
        rc, wall, out = counted(lambda: cli.main(
            ["data", "--synthetic", "40", "--out_dir", path("cli"), "--device", device]))
        write_raw_mimic(path("cli_raw"), n_subjects=40, seed=42)     # the command's tables
        run_etl(path("cli_raw"), path("cli_cpu"), device="cpu")
        if rc != 0 or sorted(os.listdir(path("cli"))) != sorted(ETL_FILES):
            raise AssertionError(f"data --synthetic 40: rc {rc}, {os.listdir(path('cli'))}")
        info["cli"] = {"wall_s": wall, "max_err_of_max_abs": etl_rule(path("cli_cpu"),
                                                                      path("cli"))}
        parts["cli"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        counts = write_raw_mimic_scaled(path("scaled"), verbose=False, **scaled)
        parts["write_raw_mimic_scaled"] = time.perf_counter() - t0
        info["scaled"] = {"tables": counts, "cut": "a tenth of ETL_BENCH_r05.log's rows"}
        for flag in ("on", "off"):
            t0 = time.perf_counter()
            run = etl_cli_run(path("scaled"), path(f"scaled_{flag}"), flag, device)
            for k, v in run.pop("launches").items():
                total[k] = total.get(k, 0) + v
            info["scaled"][flag] = run
            log(f"[etl] scaled, --use_native {flag}: {json.dumps(run)}")
            parts[f"scaled_{flag}"] = time.perf_counter() - t0
        info["scaled"]["native_vs_plain_max_err_of_max_abs"] = etl_rule(
            path("scaled_off"), path("scaled_on"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if any(total.values()):
        raise AssertionError(f"the ETL launched counted kernels: {total}")
    parts["phase"] = time.perf_counter() - t_phase
    info["seconds_by_part"] = parts
    log(f"[etl] phase 11 seconds by part: {json.dumps(parts)}")
    return total, info


# -- phase 12: data-parallel training (parallel/, --mesh) ------------------------------------

DP_BATCH, DP_STEPS, DP_PATIENTS = 16, 3, 512     # the global batch: 8 rows per rank
# The global batch of the 1-epoch experiments of (f) (32 rows per rank, 24 steps):
# two gloo ranks on one card move the 400 MB fp32 gradient through host memory
# at ~0.4-0.5 s a step, so `fame`'s batch 16 (95 steps) would take ~50 s more.
# `cli fame --mesh 1` keeps batch 16.
DP_EXP_BATCH = 64
DP_TEXT_PATIENTS, DP_TEXT_BATCH = 64, 8
# The sharded text encode against one process: the same kernels on half the
# rows of each batch (row-independent), so only the GEMM tiling of a smaller
# M differs: a few fp32 ulps of the CLS vector's max-abs.
DP_TEXT_TOL = 1e-5
# Test probabilities of a deterministic 1-epoch fp32 run (24 AdamW steps),
# two ranks against one process.  Each step's grads differ by summation order
# only ((a): ~4e-6 of max-abs), but AdamW normalises every element's update,
# so an element whose gradient is near rounding level moves by up to 2 * lr
# per step depending on the rounding; the drift grows step by step (dp_rank's
# drift curve) to a few 1e-3 of probability in one epoch, whatever order
# change started it.  So the limit is measured in the same call: the drift
# between one process and the same run with its LayerNorm unfolded
# (FMTPU_FOLD_LN=0, phase 5b: the same arithmetic in another order), times
# DP_ORDER_FACTOR.  A fault in the arithmetic, not the order, fails (a) and
# the CPU tests (the DP trajectory within 1e-8 of one process in float64).
DP_ORDER_FACTOR = 3.0
DP_PRED_FLOOR = 1e-6      # a probability's fp32 rounding: the floor of that limit
DP_TIMEOUT_S = 900
DP_DRIFT_STEPS, DP_DRIFT_AT = 10, (1, 2, 5, 10)
LN_KERNELS = ("fused_attention_block_ln", "fused_ffn_ln", "fused_attention_block_ln_bwd",
              "fused_ffn_ln_bwd")


def _counts_ln(flash, fab, ffn, addnorm, fwd, bwd, device="cuda"):
    """Every counted kernel's expected launches: #1 = #2 = fwd, #3 = #4 = bwd,
    the rest 0 (all 0 on the CPU, where the wrappers run their plain versions)."""
    want = {k: 0 for k in _all_counts(flash, fab, ffn, addnorm)}
    if device == "cuda":
        want.update(fused_attention_block_ln=fwd, fused_ffn_ln=fwd,
                    fused_attention_block_ln_bwd=bwd, fused_ffn_ln_bwd=bwd)
    return want


def _dp_small():
    """Phase 12 at CPU-rehearsal sizes (tiny widths and cohorts, a tiny BERT
    for every note encoder), set in the parent and in each rank."""
    from fairmultimodal_torch.models.bert import BertConfig
    from fairmultimodal_torch.models.text import TextEncoder

    global TRAIN_GEO, N_LABS, CLI_PATIENTS, CLI_LABS, DP_PATIENTS, DP_TEXT_PATIENTS
    N_LABS = CLI_LABS = 8
    TRAIN_GEO = dict(TRAIN_GEO, lab_token_count=N_LABS, hidden_size=32, demo_layers=1,
                     demo_heads=2, lab_layers=1, lab_heads=2, fusion_hidden=16)
    CLI_PATIENTS, DP_PATIENTS, DP_TEXT_PATIENTS = 96, 64, 8
    tiny = BertConfig(vocab_size=512, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                      intermediate_size=64, max_position_embeddings=512)
    original = TextEncoder.from_pretrained.__func__
    TextEncoder.from_pretrained = classmethod(
        lambda cls, *a, **k: original(cls, *a, **{**k, "fallback_config": tiny}))


def _reset_all(flash, fab, ffn, addnorm):
    _reset_counts(fab, ffn, addnorm)
    flash.launches = flash.bwd_launches = 0


def _param_digest(model):
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_expected(tables, batch=DP_BATCH):
    """(#1 = #2, #3 = #4) launches of a 1-epoch FAME run on ``tables`` with
    the text from the cache (per rank under a mesh: every rank runs every
    batch, on its rows), and the split sizes."""
    from fairmultimodal_torch.data.featurize import assemble_features
    from fairmultimodal_torch.pipelines.common import make_split

    idx = make_split(assemble_features(*tables).labels, 0.20, 0.05, 42)
    nb = {k: -(-len(v) // batch) for k, v in idx.items()}
    return _cli_fame_launches({"nb": nb, "text": 0}, 1, False), [len(idx[k]) for k in
                                                                 ("train", "val", "test")]


def seed0_fame():
    """FAME at TRAIN_GEO with its seed-0 weights.  Build it once and give each
    trainer a copy: a 100M-parameter init costs seconds on the host."""
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel

    return init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0)


def _dp_trainer(mesh, deterministic, device, base):
    import copy

    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    model = copy.deepcopy(base)
    return FAMETrainer(model, TrainConfig(lr=1e-4, batch_size=DP_BATCH,
                                          deterministic_forward=deterministic),
                       pos_weight=POS_WEIGHT, rngs_seed=5, device=device, mesh=mesh)


def _experiment_config(out_dir, mesh=None):
    from fairmultimodal_torch.pipelines.fame import FAMEPipelineConfig
    from fairmultimodal_torch.train.loop import TrainConfig

    geo = {k: TRAIN_GEO[k] for k in ("hidden_size", "demo_layers", "demo_heads", "lab_layers",
                                     "lab_heads", "fusion_hidden")}
    return FAMEPipelineConfig(train=TrainConfig(num_epochs=1, batch_size=DP_EXP_BATCH,
                                                deterministic_forward=True),
                              out_dir=out_dir, mesh=mesh, timing=True, **geo)


def _run_quiet(fn, device):
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, buf.getvalue()


def _artifacts(out_dir):
    import os

    names = sorted(os.listdir(out_dir))
    kinds = {k: sum(n.startswith(k) for n in names)
             for k in ("best_model_", "extracted_vectors_", "dynamic_weights_per_epoch1.csv",
                       "tracked_dynamic_weights.npy", "tracked_sigmoid_weights.npy")}
    if set(kinds.values()) != {1} or len(names) != len(kinds):
        raise AssertionError(f"artifacts in {out_dir}: {names}")
    return names


def _test_probs(out_dir):
    import glob
    import os

    with np.load(glob.glob(os.path.join(out_dir, "extracted_vectors_*.npz"))[0]) as z:
        return 1.0 / (1.0 + np.exp(-z["logits"].astype(np.float64)))


def _npz_probs(out_dir, arrays, dynamic_weights=None, device="cuda"):
    """(probabilities of ``arrays`` from the run's ``best_model_*.npz`` in
    ``FAMEPredictor``, with ``dynamic_weights`` or the run's own; the run's
    dynamic weights)."""
    import glob
    import os

    from fairmultimodal_torch.interop import load_flax_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor
    from fairmultimodal_torch.utils.checkpoint import load_metadata_npz, load_params_npz

    path = glob.glob(os.path.join(out_dir, "best_model_*.npz"))[0]
    meta = load_metadata_npz(path)
    model = load_flax_params(FAMEModel(**meta["model"]), load_params_npz(path))
    dw = np.asarray(meta["dynamic_weights"] if dynamic_weights is None else dynamic_weights)
    pred = FAMEPredictor(model, batch_size=256, dynamic_weights=dw, device=device)
    return pred.predict_arrays(arrays)["probs"], np.asarray(meta["dynamic_weights"])


def _ranks_in_background(fn, world, args, timeout_s):
    """``parallel.launch(fn, world, args=args, timeout_s=timeout_s)`` in a
    thread, so that this process runs its own checks while the ranks run:
    returns a function that waits for the ranks and returns their results
    (or raises the launch's error)."""
    import threading

    from fairmultimodal_torch import parallel

    out = {}

    def run():
        try:
            out["ranks"] = parallel.launch(fn, world, args=args, timeout_s=timeout_s)
        except BaseException as e:      # noqa: BLE001 -- re-raised by join
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["ranks"]
    return join


def _laps():
    """A part timer: ``lap(name)`` records the seconds since the last lap
    under ``name`` in ``lap.parts``."""
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        lap.parts[name] = round(now - last[0], 2)
        last[0] = now
    lap.parts = {}
    return lap


def dp_rank(root, device="cuda", small=False, ready=None):
    """Phase 12 in one of two gloo ranks sharing cuda:0 (started by
    ``parallel.launch``): (a) one deterministic step against one process,
    (b) three dropout steps (parameters bit-identical across the ranks, the
    backward bit-identical twice, the folded seeds through #2 and its plain
    version), (c) the launches of (a) and (b), (d) the dynamic-weight
    statistics against one process, (e) the sharded text encode against one
    process, (f) the 1-epoch experiment, once the file ``ready`` exists (the
    text cache it reads is whole), (g) this rank's step time.
    ``device="cpu"`` and ``small=True`` rehearse it on the CPU."""
    import hashlib
    import os

    import torch.distributed as dist

    from fairmultimodal_torch import parallel
    from fairmultimodal_torch.data.device import DeviceLoader
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.data.synthetic import make_common_frames
    from fairmultimodal_torch.models.bert import bio_clinical_bert_config
    from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
    from fairmultimodal_torch.ops import dropout_add_layernorm as addnorm
    from fairmultimodal_torch.ops import flash_attention as flash
    from fairmultimodal_torch.ops import fused_attention_block as fab
    from fairmultimodal_torch.ops import fused_ffn as ffn
    from fairmultimodal_torch.pipelines.fame import run_fame_experiment
    from fairmultimodal_torch.utils import rng as trng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if small:
        _dp_small()
    t_start = time.perf_counter()
    devices = ["cuda:0", "cuda:0"] if device == "cuda" else ["cpu", "cpu"]
    mesh = parallel.get_mesh(2, devices=devices, backend="gloo")
    rank, dev = mesh.rank, mesh.device
    res = {"rank": rank, "join_s": time.perf_counter() - t_start}
    lap = _laps()

    def gather(obj):
        out = [None] * mesh.world
        dist.all_gather_object(out, obj)
        return out

    def counts():
        return _all_counts(flash, fab, ffn, addnorm)

    cohort = synthetic_cohort(np.random.default_rng(12), DP_PATIENTS)
    keys = [k for k in cohort if k != "labels"]
    batches = [fp32_step_batch({k: v[i * DP_BATCH:] for k, v in cohort.items()}, keys, DP_BATCH)
               for i in range(1 + DP_STEPS)]
    shard = lambda b: to_device(parallel.shard_batch(b, mesh), dev)  # noqa: E731

    # (a) one deterministic step of the global batch against one process.
    _reset_all(flash, fab, ffn, addnorm)
    base = seed0_fame()
    lap("init")
    trainer = _dp_trainer(mesh, True, dev, base)
    total, _ = trainer.backward(shard(batches[0]))
    res["counts_step"] = counts()
    got = (float(total), {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()
                          if p.grad is not None})
    single = None
    if rank == 0:
        single = _dp_trainer(None, True, dev, base)
        total_s, _ = single.backward(to_device(batches[0], dev))
        want = (float(total_s), {n: p.grad.detach().cpu()
                                 for n, p in single.model.named_parameters()
                                 if p.grad is not None})
        loss_rel, worst, grad_rel = compare_steps(got, want)
        res["step_vs_single"] = {"loss": got[0], "loss_single": want[0], "loss_rel": loss_rel,
                                 "worst_leaf": worst, "worst_grad_rel": grad_rel}
        del want
    del got
    lap("a")

    # (d) the dynamic-weight statistics over a shuffled device-resident split.
    arrays, labels = {k: cohort[k] for k in keys}, cohort["labels"]
    loader = lambda m: DeviceLoader(arrays, labels, DP_BATCH, shuffle=True, seed=1,  # noqa: E731
                                    device=dev, mesh=m)
    stats = trainer.dynamic_weight_stats(loader(mesh))
    if rank == 0:
        stats_single = single.dynamic_weight_stats(loader(None))
        res["dyn_stats_identical"] = bool(np.array_equal(stats, stats_single))
        res["dyn_stats_total"] = float(stats_single.sum())
    lap("d")

    # How far the two trajectories drift apart, deterministic, step by step.
    res["drift"] = []
    probe = fp32_step_batch({k: v[-DP_BATCH:] for k, v in cohort.items()}, keys, DP_BATCH)
    for step in range(1, DP_DRIFT_STEPS + 1):
        b = batches[step % len(batches)]
        trainer.train_step(shard(b))
        if rank == 0:
            single.train_step(to_device(b, dev))
        if step in DP_DRIFT_AT:
            _, logits, _ = trainer.validate([probe])
            if rank == 0:
                _, logits_s, _ = single.validate([probe])
                pairs = list(zip(trainer.model.parameters(), single.model.parameters()))
                res["drift"].append({
                    "step": step,
                    "param_max_abs": max(float((a - b).abs().max()) for a, b in pairs),
                    "params_differing": sum(int((a != b).sum()) for a, b in pairs),
                    "prob_max_abs": float(np.abs(1 / (1 + np.exp(-logits))
                                                 - 1 / (1 + np.exp(-logits_s))).max())})
    del trainer, single
    torch.cuda.empty_cache()
    lap("drift")

    # (b) three steps with dropout: the parameters after each, on both ranks.
    _reset_all(flash, fab, ffn, addnorm)
    trainer_d = _dp_trainer(mesh, False, dev, base)
    digests = []
    for b in batches[1:]:
        trainer_d.train_step(shard(b))
        digests.append(_param_digest(trainer_d.model))
    res["counts_steps"] = counts()
    res["digests"] = gather(digests)
    state, batch = trainer_d.generator.get_state(), shard(batches[1])
    runs = []
    for _ in range(2):
        trainer_d.generator.set_state(state)
        trainer_d.backward(batch)
        runs.append([p.grad.clone() for p in trainer_d.model.parameters() if p.grad is not None])
    res["backward_twice_identical"] = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs
    # This rank's folded seeds through #2 and its plain version (fp32, lab rows).
    gen = torch.Generator(device=dev).manual_seed(4)
    rn = lambda *shape, std=1.0: torch.randn(*shape, generator=gen, device=dev) * std  # noqa: E731
    inputs = [rn(DP_BATCH // 2 * 560, 768), rn(2048, 768, std=768 ** -0.5), rn(2048, std=0.02),
              rn(768, 2048, std=2048 ** -0.5), rn(768, std=0.02), 1 + 0.1 * rn(768), 0.1 * rn(768)]
    seeds = tuple(trng.draw_seed(trng.RankGenerator(trng.make_generator(s), rank))
                  for s in (21, 22))
    kw = dict(activation="relu", ln_eps=1e-5, rate=0.1, seeds=seeds)
    with torch.no_grad():
        out_k = ffn.fused_ffn_ln(*inputs, deterministic=False, **kw)
        out_p = ffn.fused_ffn_ln_reference(*inputs, **kw)
    res["folded_seeds"] = [hex(s) for s in seeds]
    res["folded_kernel_vs_plain"] = float((out_k - out_p).abs().max())
    res["folded_out_digests"] = gather(hashlib.blake2b(out_k.cpu().numpy().tobytes(),
                                                       digest_size=16).hexdigest())
    del inputs, out_k, out_p
    lap("b")

    # (e) the sharded text encode (no cache) against one process.
    notes = make_cohort(np.random.default_rng(3), DP_TEXT_PATIENTS)
    cache = os.environ.pop("FMTPU_TEXT_CACHE", None)
    try:
        encoder = TextEncoder.from_pretrained(fallback_config=bio_clinical_bert_config(), seed=1,
                                              device=dev, mesh=mesh)
        _reset_all(flash, fab, ffn, addnorm)
        emb = encode_note_chunks(encoder, notes, max_length=512, batch_size=DP_TEXT_BATCH)
        res["counts_text"] = counts()
        res["text_expected"] = expected_text_launches(encoder.tokenizer, notes, DP_TEXT_BATCH,
                                                      12)
        if rank == 0:
            one = TextEncoder(encoder.config, encoder.model, encoder.tokenizer, device=dev)
            want = encode_note_chunks(one, notes, max_length=512, batch_size=DP_TEXT_BATCH)
            res["text_rel"] = float(np.abs(emb - want).max() / np.abs(want).max())
            res["text_zero_rows"] = bool(not emb[[not c for c in notes]].any())
            del one
        del encoder
    finally:
        if cache is not None:
            os.environ["FMTPU_TEXT_CACHE"] = cache
    torch.cuda.empty_cache()
    lap("e")

    # (f) the experiment on phase 7's cohort, 1 epoch, deterministic forward.
    deadline = time.monotonic() + DP_TIMEOUT_S
    while ready is not None and not os.path.exists(ready):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: no {ready} after {DP_TIMEOUT_S} s")
        time.sleep(0.1)
    tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
    _reset_all(flash, fab, ffn, addnorm)
    out, wall, printed = _run_quiet(lambda: run_fame_experiment(
        *tables, _experiment_config(os.path.join(root, "dp_out"), mesh), device=dev), device)
    res["counts_experiment"] = counts()
    res["experiment"] = {
        "wall_s": wall, "timings": out["timings"], "artifacts": out["artifacts"],
        "printed_lines": len(printed.splitlines()), "history": out["history"],
        "splits": [len(out["splits"][k]) for k in ("train", "val", "test")],
        "metrics": {t: [m["aucroc"], m["auprc"]] for t, m in out["metrics"].items()}}
    res["experiment_tail"] = printed.splitlines()[-12:]
    del out
    torch.cuda.empty_cache()
    lap("f")

    # (g) this rank's train step, both ranks stepping together on the card.
    res["step"] = time_train_step(trainer_d, batch, steps=5, warmup=1) if device == "cuda" \
        else {}
    lap("g")
    res["parts_s"] = lap.parts
    res["total_s"] = time.perf_counter() - t_start
    return res


def one_process_refs(flash, fab, ffn, addnorm, tables, root, device):
    """The one-process experiment of phases 12 (f) and 13 (d) (deterministic,
    1 epoch, global batch DP_EXP_BATCH) and the same run with its LayerNorm
    unfolded: the reference test probabilities and the order drift a mesh's
    run is held to.  Both write under ``root`` and fill the text cache."""
    import os

    from fairmultimodal_torch.pipelines.fame import build_model_arrays, run_fame_experiment

    _reset_all(flash, fab, ffn, addnorm)
    single, wall, _ = _run_quiet(lambda: run_fame_experiment(
        *tables, _experiment_config(os.path.join(root, "single")), device=device), device)
    out = {"single": {"wall_s": wall, "timings": single["timings"],
                      "counts": _all_counts(flash, fab, ffn, addnorm)},
           "test_arrays": {k: v[single["splits"]["test"]]
                           for k, v in build_model_arrays(single["bundle"]).items()},
           "splits": [len(single["splits"][k]) for k in ("train", "val", "test")]}
    del single
    log(f"[refs] one process: {json.dumps(out['single'])}")
    os.environ["FMTPU_FOLD_LN"] = "0"
    try:
        _, wall, _ = _run_quiet(lambda: run_fame_experiment(
            *tables, _experiment_config(os.path.join(root, "unfolded")), device=device), device)
    finally:
        del os.environ["FMTPU_FOLD_LN"]
    out["test_probs"] = _test_probs(os.path.join(root, "single"))
    out["order_drift"] = float(np.abs(_test_probs(os.path.join(root, "unfolded"))
                                      - out["test_probs"]).max())
    out["order_drift_run"] = {"wall_s": wall, "test_prob_max_abs": out["order_drift"]}
    # The saved parameters' test probabilities with the folded run's dynamic
    # weights: the drift without the dynamic weights' threshold steps.
    out["npz"] = _npz_probs(os.path.join(root, "single"), out["test_arrays"], device=device)
    out["npz_unfolded"] = _npz_probs(os.path.join(root, "unfolded"), out["test_arrays"],
                                     out["npz"][1], device=device)
    out["order_drift_equal_weights"] = float(np.abs(out["npz_unfolded"][0]
                                                    - out["npz"][0]).max())
    log(f"[refs] one process, LayerNorm unfolded, against folded: max |p| difference "
        f"{out['order_drift']:.3e} ({wall:.1f} s)")
    return out


def dp_phase(flash, fab, ffn, addnorm, device="cuda", small=False, keep=None):
    """Phase 12: data parallelism.  One process against the two gloo ranks of
    :func:`dp_rank` sharing cuda:0; ``cli fame --mesh 1`` on one NCCL rank;
    the train step on one NCCL rank against no mesh in turns.
    ``device="cpu"`` and ``small=True`` rehearse it on the CPU (gloo, no
    timing).  ``keep`` receives :func:`one_process_refs` for phase 13."""
    import gc
    import importlib
    import os
    import shutil

    from fairmultimodal_torch import parallel
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.data.synthetic import make_common_frames

    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    if small:
        _dp_small()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase12")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_cache = os.environ.get("FMTPU_TEXT_CACHE")
    os.environ["FMTPU_TEXT_CACHE"] = os.path.join(root, "text_cache")
    info, parts = {}, {}
    try:
        if device == "cuda":
            info["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60).stdout.strip()
            log(f"[dp] card: {info['card']}")
        tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
        (fwd, bwd), splits = dp_expected(tables, DP_EXP_BATCH)
        want = _counts_ln(flash, fab, ffn, addnorm, fwd, bwd, device)
        (cli_fwd, cli_bwd), _ = dp_expected(tables, DP_BATCH)
        want_cli = _counts_ln(flash, fab, ffn, addnorm, cli_fwd, cli_bwd, device)
        log(f"[dp] predicted per rank of a 1-epoch run (text cached): batch {DP_EXP_BATCH} "
            f"#1 = #2 {fwd}, #3 = #4 {bwd}, the command line's batch {DP_BATCH} {cli_fwd} / "
            f"{cli_bwd}; splits {splits}; (a) 2 / 2, (b) {2 * DP_STEPS} / {2 * DP_STEPS}")

        # The two gloo ranks on cuda:0, in their own processes.  Meanwhile this
        # process runs one process, deterministic, and its LayerNorm-unfolded
        # twin (the reference of (f) and the drift it is held to; they fill
        # the text cache, and the ranks start (f) once ``ready`` says so), then
        # cli fame --mesh 1 (one NCCL rank, the command line's own path).
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ready = os.path.join(root, "text_cache_ready")
        join_ranks = _ranks_in_background(dp_rank, 2, (root, device, small, ready),
                                          DP_TIMEOUT_S)
        try:
            try:
                refs = one_process_refs(flash, fab, ffn, addnorm, tables, root, device)
            finally:
                open(ready, "w").close()
            parts["one_process_refs"] = time.perf_counter() - t0
            info["single"], info["order_drift"] = refs["single"], refs["order_drift_run"]
            order_drift, test_arrays = refs["order_drift"], refs["test_arrays"]
            if keep is not None:
                keep.update(refs)
            t1 = time.perf_counter()
            _reset_all(flash, fab, ffn, addnorm)
            rc, wall, printed = _run_quiet(lambda: cli.main(
                ["fame", "--synthetic", str(CLI_PATIENTS), "--synthetic_labs", str(CLI_LABS),
                 "--epochs", "1", "--mesh", "1", "--timing", "--text_cache",
                 os.environ["FMTPU_TEXT_CACHE"], "--out_dir", os.path.join(root, "cli_mesh1"),
                 "--device", device] + (["--tiny"] if small else [])), device)
            info["cli_mesh1"] = {"rc": rc, "wall_s": wall,
                                 "counts": _all_counts(flash, fab, ffn, addnorm),
                                 "artifacts": _artifacts(os.path.join(root, "cli_mesh1")),
                                 "auroc_lines": [ln for ln in printed.splitlines()
                                                 if "AUROC" in ln or "AUPRC" in ln]}
            log(f"[dp] cli fame --mesh 1 (NCCL, world 1): {json.dumps(info['cli_mesh1'])}")
            if rc != 0 or info["cli_mesh1"]["counts"] != want_cli:
                raise AssertionError(f"cli --mesh 1: rc {rc}, launches "
                                     f"{info['cli_mesh1']['counts']}, predicted {want_cli}")
            aucs = [float(ln.split(":")[1]) for ln in info["cli_mesh1"]["auroc_lines"]]
            if len(aucs) != 6 or not np.isfinite(aucs).all():
                raise AssertionError("cli --mesh 1 metric lines "
                                     f"{info['cli_mesh1']['auroc_lines']}")
            parts["cli_mesh1"] = time.perf_counter() - t1
        finally:
            ranks = join_ranks()
        info["ranks_s"] = parts["ranks"] = time.perf_counter() - t0
        r0, r1 = ranks
        parts.update({f"rank 0 {k}": v for k, v in r0["parts_s"].items()})
        for r in ranks:
            log(f"[dp] rank {r['rank']}: " + json.dumps(
                {k: v for k, v in r.items() if k not in ("digests", "experiment_tail")}))
        log("[dp] rank 0's report:\n[dp]   " + "\n[dp]   ".join(r0["experiment_tail"]))

        step_want = _counts_ln(flash, fab, ffn, addnorm, 2, 2, device)
        steps_want = _counts_ln(flash, fab, ffn, addnorm, 2 * DP_STEPS, 2 * DP_STEPS, device)
        text_want = _counts_ln(flash, fab, ffn, addnorm, r0["text_expected"], 0, device)
        a = r0["step_vs_single"]
        checks = {
            "(a) step vs one process": a["loss_rel"] <= XDEV_LOSS_TOL
            and a["worst_grad_rel"] <= XDEV_GRAD_TOL,
            "(b) parameters bit-identical across ranks": r0["digests"][0] == r0["digests"][1]
            and len(set(r0["digests"][0])) == DP_STEPS,
            "(b) backward bit-identical twice": r0["backward_twice_identical"]
            and r1["backward_twice_identical"],
            "(b) folded seeds: kernel = plain, ranks differ": max(
                r0["folded_kernel_vs_plain"], r1["folded_kernel_vs_plain"]) <= FP32_TOL
            and r0["folded_out_digests"][0] != r0["folded_out_digests"][1],
            "(c) launches of (a), (b), (e), (f) and one process's run": all(
                r["counts_step"] == step_want and r["counts_steps"] == steps_want
                and r["counts_text"] == text_want and r["counts_experiment"] == want
                for r in ranks) and (r0["text_expected"] > 0 or device == "cpu")
            and info["single"]["counts"] == want,
            "(d) dynamic-weight statistics bit-identical": r0["dyn_stats_identical"]
            and r0["dyn_stats_total"] > 0,
            "(e) sharded text encode": r0["text_rel"] <= DP_TEXT_TOL and r0["text_zero_rows"],
            "(f) metrics finite": all(np.isfinite(v).all()
                                      for v in r0["experiment"]["metrics"].values()),
            "(f) rank 0 alone writes and prints": bool(r0["experiment"]["artifacts"])
            and not r1["experiment"]["artifacts"] and r1["experiment"]["printed_lines"] == 0,
            "(f) splits": r0["experiment"]["splits"] == splits,
        }
        info["dp_artifacts"] = _artifacts(os.path.join(root, "dp_out"))
        diff = float(np.abs(_test_probs(os.path.join(root, "dp_out"))
                            - _test_probs(os.path.join(root, "single"))).max())
        limit = max(DP_ORDER_FACTOR * order_drift, DP_PRED_FLOOR)
        checks["(f) two ranks vs one process, test probabilities"] = diff <= limit
        if device == "cuda":
            p_single, dw_single = refs["npz"]
            p_dp, dw_dp = _npz_probs(os.path.join(root, "dp_out"), test_arrays, dw_single)
            info["npz"] = {"dynamic_weights_single": dw_single.tolist(),
                           "dynamic_weights_dp": dw_dp.tolist(),
                           "dynamic_weights_max_abs": float(np.abs(dw_dp - dw_single).max()),
                           "probs_same_dynamic_weights_max_abs":
                               float(np.abs(p_dp - p_single).max()),
                           "probs_same_dynamic_weights_mean_abs":
                               float(np.abs(p_dp - p_single).mean())}
        info.update(checks=checks, test_prob_max_abs=diff, test_prob_limit=limit,
                    ranks={r["rank"]: {k: v for k, v in r.items()
                                       if k not in ("digests", "experiment_tail")}
                           for r in ranks})
        log(f"[dp] two ranks vs one process: max |p| difference {diff:.3e} "
            f"(limit {limit:.3e}: {DP_ORDER_FACTOR} x the unfolded run's, at least "
            f"{DP_PRED_FLOOR}); "
            f"{json.dumps(info.get('npz'))}; drift "
            f"{json.dumps(r0['drift'])}; checks {json.dumps(checks)}")

        # (g) the default train step on one NCCL rank against no mesh, in turns.
        t0 = time.perf_counter()
        cohort = synthetic_cohort(np.random.default_rng(12), DP_BATCH)
        batch = to_device(fp32_step_batch(cohort, [k for k in cohort if k != "labels"],
                                          DP_BATCH), torch.device(device))
        mesh1 = parallel.get_mesh(1, devices=None if device == "cuda" else [device])
        try:
            base = seed0_fame()
            trainers = {"no_mesh": _dp_trainer(None, False, device, base),
                        "nccl_world1": _dp_trainer(mesh1, False, device, base)}
            del base
            if device == "cuda":
                turns = {k: [] for k in trainers}
                for name in ("no_mesh", "nccl_world1", "nccl_world1", "no_mesh"):
                    turns[name].append(time_train_step(trainers[name], batch, steps=10)
                                       ["train_step_ms"])
                info["step_ms"] = {
                    "turns": turns,
                    "profile": {k: profile_train_step(t, batch) for k, t in trainers.items()},
                    "two_gloo_ranks_one_card": [r["step"]["train_step_ms"] for r in ranks]}
            else:
                info["step_ms"] = {k: float(t.train_step(batch)[0]) for k, t in trainers.items()}
            del trainers
        finally:
            mesh1.close()
        parts["step_turns"] = time.perf_counter() - t0
        info["seconds_by_part"] = parts
        log(f"[dp] train step fp32 batch 16 (global): {json.dumps(info['step_ms'])}; "
            f"phase 12 seconds by part: {json.dumps(parts)}")
        if not all(checks.values()):
            raise AssertionError(f"phase 12 failed: {[k for k, v in checks.items() if not v]}")
        info["launches_dp"] = {k: {"rank0": r0["counts_experiment"][k],
                                   "rank1": r1["counts_experiment"][k],
                                   "cli_mesh1_nccl": info["cli_mesh1"]["counts"][k]}
                               for k in r0["counts_experiment"]}
    finally:
        if saved_cache is None:
            os.environ.pop("FMTPU_TEXT_CACHE", None)
        else:
            os.environ["FMTPU_TEXT_CACHE"] = saved_cache
        if keep is not None and os.path.isdir(os.path.join(root, "text_cache")):
            # Phase 13 reads the same cohort's text from it (and removes it).
            keep["text_cache"] = os.path.join(os.path.dirname(root), "phase13_text_cache")
            shutil.rmtree(keep["text_cache"], ignore_errors=True)
            os.replace(os.path.join(root, "text_cache"), keep["text_cache"])
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return info["launches_dp"], info


# -- phase 13: tensor parallelism (parallel.shard_params_tp, --mesh DxM) -------------------

# Two gloo ranks on cuda:0 as a 1 x 2 mesh (NCCL refuses two ranks on one
# device), fp32, the reference geometry.  The JAX package's limit for the eval
# loss of sharded parameters (tests/test_parallel.py:94); the step is held to
# phase 5's card-vs-CPU limits (the lab layers run the flash route and #7 / #8
# on the sharded path, #1-#4 in one process: another summation order).
TP_EVAL_TOL = 2e-5
TP_BATCH, TP_STEPS = 16, 3
TP_TIMEOUT_S = 900


def tp_want(flash, fab, ffn, addnorm, fwd, bwd, device="cuda"):
    """Every counted kernel's launches per rank of a sharded FAME model over
    ``fwd`` forward and ``bwd`` backward passes: each lab layer runs #9 and #7
    once forward (the flash route on its local heads, the FFN on its local
    columns) and the glue twice; #10, #8 once and the glue's backward twice
    backward.  The demo BERT (S 1) launches none, and the LN-fused and
    megakernel paths (#1-#6) never run on a sharded layer.  All 0 on the CPU."""
    want = {k: 0 for k in _all_counts(flash, fab, ffn, addnorm)}
    if device == "cuda":
        n = TRAIN_GEO["lab_layers"]
        want.update(flash_attention=n * fwd, fused_ffn=n * fwd, glue=2 * n * fwd,
                    flash_attention_bwd=n * bwd, fused_ffn_bwd=n * bwd, glue_bwd=2 * n * bwd)
    return want


def _tp_forward_passes(splits, batch, epochs=1):
    """(forward, backward) passes per rank of a 1-epoch FAME run on a mesh
    with one data rank: train and its dynamic-weight pass, validation, the
    final validation, test predictions and extraction."""
    nb = dict(zip(("train", "val", "test"), (-(-n // batch) for n in splits)))
    return (epochs * (2 * nb["train"] + nb["val"]) + nb["val"] + 2 * nb["test"],
            epochs * nb["train"])


def tp_rank(root, device="cuda", small=False):
    """Phase 13 in one of two gloo ranks sharing cuda:0 (a 1 x 2 mesh):
    (a) the eval loss and one deterministic step against one process, (b)
    three dropout steps (replicated parameters bit-identical across the
    ranks, shards different, the backward bit-identical twice, #7 with each
    rank's inner seed and the glue with the shared outer one), (c) the
    launches of (a), (b) and (d), (d) the 1-epoch experiment, (e) parameter
    bytes, peak memory and this rank's step time."""
    import copy
    import hashlib
    import os

    import torch.distributed as dist

    from fairmultimodal_torch import parallel
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.data.synthetic import make_common_frames
    from fairmultimodal_torch.models import behrt
    from fairmultimodal_torch.ops import dropout_add_layernorm as addnorm
    from fairmultimodal_torch.ops import flash_attention as flash
    from fairmultimodal_torch.ops import fused_attention_block as fab
    from fairmultimodal_torch.ops import fused_ffn as ffn
    from fairmultimodal_torch.pipelines.fame import run_fame_experiment
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
    from fairmultimodal_torch.utils.rng import Dropout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if small:
        _dp_small()
    t_start = time.perf_counter()
    devices = ["cuda:0", "cuda:0"] if device == "cuda" else [device] * 2
    mesh = parallel.get_mesh(1, 2, devices=devices, backend="gloo")
    rank, dev = mesh.rank, mesh.device
    res = {"rank": rank, "join_s": time.perf_counter() - t_start}
    lap = _laps()
    cuda = dev.type == "cuda"

    def gather(obj):
        out = [None] * mesh.world
        dist.all_gather_object(out, obj)
        return out

    def digest(tensors):
        h = hashlib.blake2b(digest_size=16)
        for t in tensors:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def mem():
        return torch.cuda.memory_allocated() / 1e9 if cuda else 0.0

    base = seed0_fame()
    lap("init")

    def trainer(sharded, deterministic, route=False):
        model = copy.deepcopy(base)
        if sharded:
            parallel.shard_params_tp(model, mesh)
        if route:
            tp_route(model)
        return FAMETrainer(model, TrainConfig(lr=1e-4, batch_size=TP_BATCH,
                                              deterministic_forward=deterministic),
                           pos_weight=POS_WEIGHT, rngs_seed=5, device=dev,
                           mesh=mesh if sharded else None)

    def grads(t):
        named = {n: p.grad for n, p in t.model.named_parameters() if p.grad is not None}
        return {n: g.detach().cpu() for n, g in parallel.full_state_dict(t.model, named).items()}

    cohort = synthetic_cohort(np.random.default_rng(12), (1 + TP_STEPS) * TP_BATCH)
    keys = [k for k in cohort if k != "labels"]
    batches = [fp32_step_batch({k: v[i * TP_BATCH:] for k, v in cohort.items()}, keys,
                               TP_BATCH) for i in range(1 + TP_STEPS)]

    # The lab layers' FFN inputs of a backward: where W1's relu gates lie.
    ffn_inputs, ffn_call = {}, behrt.fused_ffn

    def backward(t, key):
        ffn_inputs[key] = []

        def capture(x, *args, **kwargs):
            ffn_inputs[key].append(x.detach().clone())
            return ffn_call(x, *args, **kwargs)

        behrt.fused_ffn = capture
        try:
            return t.backward(batch)
        finally:
            behrt.fused_ffn = ffn_call

    # (a) the eval loss and one deterministic step, against one process; (e) memory.
    _reset_all(flash, fab, ffn, addnorm)
    tp = trainer(True, True)
    loss_tp = tp.validate([batches[0]])[0]
    batch = to_device(batches[0], dev)
    before = mem()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    total, _ = backward(tp, "tp")
    res["counts_a"] = _all_counts(flash, fab, ffn, addnorm)
    res["memory"] = {"param_bytes": sum(p.numel() * p.element_size()
                                        for p in tp.model.parameters()),
                     "allocated_before_step_gb": before,
                     "peak_step_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}
    got = (float(total), grads(tp))
    del tp
    if rank == 0:
        # One process on the sharded layers' route (the flash route and
        # #7 / #8 with the glue; the check), and on the default folded one
        # (#1-#4; recorded, with the memory of one process).
        res["a"] = {}
        for route in (True, False):
            one = trainer(False, True, route)
            loss_one = one.validate([batches[0]])[0]
            before = mem()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            total_one, _ = backward(one, "one") if route else one.backward(batch)
            if not route:
                res["memory_one_process"] = {
                    "param_bytes": sum(p.numel() * p.element_size()
                                       for p in one.model.parameters()),
                    "allocated_before_step_gb": before,
                    "peak_step_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}
            want = (float(total_one), grads(one))
            loss_rel, worst, grad_rel = compare_steps(got, want)
            res["a"]["same_route" if route else "folded"] = row = {
                "eval_loss": loss_tp, "eval_loss_one": loss_one,
                "eval_rel": abs(loss_tp - loss_one) / abs(loss_one), "loss": got[0],
                "loss_one": float(total_one), "loss_rel": loss_rel, "worst_leaf": worst,
                "worst_grad_rel": grad_rel}
            if route:
                # W1's relu gates that the two runs set otherwise (their FFN
                # inputs differ by rounding): phase 8's rule with those units'
                # W1 rows / b1 entries and the tokens' positional rows set to
                # one process's values.
                flips = relu_gate_flips(ffn, base, ffn_inputs["tp"], ffn_inputs["one"], dev)
                kept = dict(got[1])
                for name, rows in flips["rows"].items():
                    if rows:
                        kept[name] = got[1][name].clone()
                        kept[name][rows] = want[1][name][rows]
                _, worst_kept, rel_kept = compare_steps((got[0], kept), want)
                row.update(relu_flips={k: v for k, v in flips.items() if k != "rows"},
                           worst_leaf_flips_set=worst_kept, worst_grad_rel_flips_set=rel_kept)
            del one, want
    del got
    if cuda:
        torch.cuda.empty_cache()
    lap("a")

    # (b) three dropout steps; the seeds the lab layers draw in the first.
    drawn, draw = [], behrt.dropout_seed

    def recording(module, rate, generator, sharded=False):
        seed = draw(module, rate, generator, sharded)
        drawn.append((sharded, seed))
        return seed

    _reset_all(flash, fab, ffn, addnorm)
    td = trainer(True, False)
    plan = parallel.tp_plan(td.model)
    named = dict(td.model.named_parameters())
    digests = []
    behrt.dropout_seed = recording
    try:
        for i, b in enumerate(batches[1:]):
            td.train_step(to_device(b, dev))
            digests.append((digest(p for n, p in named.items() if n not in plan),
                            digest(named[n] for n in plan)))
            if i == 0:
                seeds = list(drawn)
    finally:
        behrt.dropout_seed = draw
    state, batch = td.generator.get_state(), to_device(batches[1], dev)
    twice = []
    for _ in range(2):
        td.generator.set_state(state)
        td.backward(batch)
        twice.append(digest(p.grad for p in td.model.parameters() if p.grad is not None))
    res["counts_b"] = _all_counts(flash, fab, ffn, addnorm)
    res["digests"] = gather(digests)
    res["backward_twice_identical"] = twice[0] == twice[1]
    res["seeds"] = gather([(flag, hex(sd)) for flag, sd in seeds])
    # #7 with this rank's inner seed and the glue with the outer one, on the
    # same inputs on both ranks (fp32, this rank's 1024 columns of the lab FFN).
    inner, outer = seeds[1][1], seeds[2][1]
    gen = torch.Generator(device=dev).manual_seed(4)
    rn = lambda *shape, std=1.0: torch.randn(*shape, generator=gen, device=dev) * std  # noqa: E731
    h, f = TRAIN_GEO["hidden_size"], td.model.behrt_lab.layer_0.ffn_in.out_features
    r = TP_BATCH * _round16(TRAIN_GEO["lab_token_count"])
    x = rn(r, h)
    inputs = [x, rn(f, h, std=h ** -0.5), rn(f, std=0.02), rn(h, f, std=f ** -0.5),
              torch.zeros(h, device=dev)]
    ln, y_in = [1 + 0.1 * rn(h), 0.1 * rn(h)], rn(r, h)
    with torch.no_grad():
        y = ffn.fused_ffn(*inputs, activation="relu", rate=0.1, deterministic=False, seed=inner)
        y_plain = ffn.fused_ffn_reference(*inputs, activation="relu", rate=0.1, seed=inner)
        drop = Dropout.make(outer, 1, 0.1)
        z = addnorm.dropout_add_layernorm(x, y_in, *ln, eps=1e-5, dropout=drop)
        z_plain = addnorm.dropout_add_layernorm_reference(x, y_in, *ln, eps=1e-5, dropout=drop)
    res["inner_kernel_vs_plain"] = float((y - y_plain).abs().max())
    res["outer_kernel_vs_plain"] = float((z - z_plain).abs().max())
    res["inner_digests"] = gather(digest([y]))
    res["outer_digests"] = gather(digest([z]))
    del inputs, x, y, y_plain, y_in, z, z_plain
    if cuda:
        torch.cuda.empty_cache()
    lap("b")

    # (d) the experiment on phase 7's cohort, 1 epoch, deterministic, global batch 64.
    tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
    _reset_all(flash, fab, ffn, addnorm)
    out, wall, printed = _run_quiet(lambda: run_fame_experiment(
        *tables, _experiment_config(os.path.join(root, "tp_out"), mesh), device=dev),
        device)
    res["counts_d"] = _all_counts(flash, fab, ffn, addnorm)
    trained = out["trainer"].model
    res["experiment"] = {
        "wall_s": wall, "timings": out["timings"], "artifacts": out["artifacts"],
        "printed_lines": len(printed.splitlines()), "history": out["history"],
        "splits": [len(out["splits"][k]) for k in ("train", "val", "test")],
        "metrics": {t: [m["aucroc"], m["auprc"]] for t, m in out["metrics"].items()},
        "sharded_leaves": len(parallel.tp_plan(trained)),
        "local_param_bytes": sum(p.numel() * p.element_size() for p in trained.parameters())}
    res["experiment_tail"] = printed.splitlines()[-12:]
    del out, trained
    if cuda:
        torch.cuda.empty_cache()
    lap("d")

    # (e) this rank's train step, both ranks stepping together on the card.
    res["step"] = time_train_step(td, batch, steps=5, warmup=1) if cuda else {}
    lap("e")
    res["parts_s"] = lap.parts
    res["total_s"] = time.perf_counter() - t_start
    return res


def _round16(n):
    return -(-n // 16) * 16


def relu_gate_flips(ffn, base, xs_tp, xs_one, dev):
    """The relu gates of each lab layer's W1 that the sharded run and one
    process set otherwise: #7's W1 stage on each run's FFN input (the
    sharded run's per half of the units, as its ranks run it), gates compared;
    each flip's |h| in float64 against the largest |h| (a flip must lie within
    REPLAY_FLIP_TOL of zero).  Returns the counts, that share, and the rows of
    the W1 / b1 / positional leaves the flips write."""
    from fairmultimodal_torch.utils.rng import Dropout

    out = {"flips": [], "units": [], "h_at_flip_share": 0.0, "rows": {}}
    tokens = set()
    s = _round16(TRAIN_GEO["lab_token_count"])
    for i, (x_tp, x_one) in enumerate(zip(xs_tp, xs_one)):
        lin = getattr(base.behrt_lab, f"layer_{i}").ffn_in
        w1, b1 = lin.weight.detach().to(dev), lin.bias.detach().to(dev)

        def gates(x, w, b):
            stages, _, saved = ffn.ffn_stages(
                x, w, b, torch.zeros(x.shape[1], w.shape[0], device=dev),
                torch.zeros(x.shape[1], device=dev), activation="relu", inner=Dropout(),
                residuals=True)
            ffn._run(stages[:1])
            return saved["hd"] > 0

        half = w1.shape[0] // 2
        with torch.no_grad():
            flips = torch.cat([gates(x_tp, w1[:half], b1[:half]),
                               gates(x_tp, w1[half:], b1[half:])], 1) != gates(x_one, w1, b1)
            h = x_one.double() @ w1.double().t() + b1.double()
            if flips.any():
                out["h_at_flip_share"] = max(out["h_at_flip_share"], float(
                    h[flips].abs().max() / h.abs().max()))
        units = flips.any(0).nonzero().flatten().tolist()
        tokens.update(t % s for t in flips.any(1).nonzero().flatten().tolist()
                      if t % s < TRAIN_GEO["lab_token_count"])
        out["flips"].append(int(flips.sum()))
        out["units"].append(units)
        for leaf in ("weight", "bias"):
            out["rows"][f"behrt_lab.layer_{i}.ffn_in.{leaf}"] = units
        del flips, h
    out["rows"]["behrt_lab.pos_embedding"] = sorted(tokens)
    return out


def tp_route(model):
    """One process on the route a sharded lab layer takes (the flash route,
    ``fused_ffn`` and the glue; ``shard_params_tp`` sets these fields): the
    same kernels in the same order but the split reduction."""
    return set_flash(set_fold(model, False))


def same_route_run(tables, out_dir, device, split=False):
    """The one-process experiment of (d) with every lab layer on the sharded
    route (``pipelines.fame``'s init wrapped for the run).  ``split``: each
    row-parallel product (attention output, FFN output, of the lab layers and
    the demo BERT) summed from its two K halves, the bias after -- the sums a
    1 x 2 mesh does, in one process."""
    import torch.nn.functional as F

    from fairmultimodal_torch.models import behrt, bert
    from fairmultimodal_torch.pipelines import fame

    init, row, ffn_call = fame.init_params, behrt.row_linear, behrt.fused_ffn

    def row_linear(x, lin, dtype, tp):
        w, x = lin.weight.to(dtype), x.to(dtype)
        k = w.shape[1] // 2
        return F.linear(x[..., :k], w[:, :k]) + F.linear(x[..., k:], w[:, k:]) + \
            lin.bias.to(dtype)

    def fused_ffn(x, w1, b1, w2, b2, **kwargs):
        f, zero = w1.shape[0] // 2, torch.zeros_like(b2)
        return ffn_call(x, w1[:f], b1[:f], w2[:, :f], zero, **kwargs) + \
            ffn_call(x, w1[f:], b1[f:], w2[:, f:], zero, **kwargs) + b2

    fame.init_params = lambda model, seed: tp_route(init(model, seed))
    if split:
        behrt.row_linear = bert.row_linear = row_linear
        behrt.fused_ffn = fused_ffn
    try:
        return _run_quiet(lambda: fame.run_fame_experiment(
            *tables, _experiment_config(out_dir), device=device), device)
    finally:
        fame.init_params, behrt.fused_ffn = init, ffn_call
        behrt.row_linear = bert.row_linear = row


def tp_phase(flash, fab, ffn, addnorm, refs=None, device="cuda", small=False):
    """Phase 13: tensor parallelism.  #7-#10 at the sharded layer's shapes
    against their plain versions, then the two gloo ranks of :func:`tp_rank`
    on cuda:0 as a 1 x 2 mesh against one process.  ``refs``: phase 12's
    :func:`one_process_refs` (run here when None).  ``device="cpu"`` and
    ``small=True`` rehearse it on the CPU (gloo, no timing)."""
    import gc
    import glob
    import os
    import shutil

    from fairmultimodal_torch.data.synthetic import make_common_frames
    from fairmultimodal_torch.utils.checkpoint import load_params_npz

    if small:
        _dp_small()
    t_phase = time.perf_counter()
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    root = os.path.join(base, "phase13")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_cache = os.environ.get("FMTPU_TEXT_CACHE")
    refs = dict(refs or {})
    os.environ["FMTPU_TEXT_CACHE"] = refs.get("text_cache") or os.path.join(root, "text_cache")
    info, parts = {}, {}
    try:
        if device == "cuda":
            info["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60).stdout.strip()
            # The sharded layer's kernels at its shapes (8 / 2 heads, 2048 / 2
            # columns, batch 16) against their plain versions, timed.
            t0 = time.perf_counter()
            g = torch.Generator(device="cuda").manual_seed(13)
            nh = TRAIN_GEO["lab_heads"] // 2
            info["kernels"] = {
                "flash": flash_check(flash, g, torch.float32, B=TP_BATCH, S=560, nh=nh,
                                     d=TRAIN_GEO["hidden_size"] // TRAIN_GEO["lab_heads"],
                                     mask_kind="lab", timed=True, peak=FP32_PEAK,
                                     stages=False),
                "ffn": unfolded_ffn_check(ffn, g, torch.float32, 0.1, R=TP_BATCH * 560,
                                          F=1024, timed=True, peak=FP32_PEAK)}
            parts["kernels"] = time.perf_counter() - t0
            log(f"[tp] the sharded layer's kernels: {json.dumps(info['kernels'])}")
        tables = make_common_frames(CLI_PATIENTS, CLI_LABS, 3, seed=42)
        t0 = time.perf_counter()
        if "test_probs" not in refs:
            refs.update(one_process_refs(flash, fab, ffn, addnorm, tables, root, device))
        parts["one_process_refs"] = time.perf_counter() - t0
        fwd, bwd = _tp_forward_passes(refs["splits"], DP_EXP_BATCH)
        want = {"a": tp_want(flash, fab, ffn, addnorm, 2, 1, device),
                "b": tp_want(flash, fab, ffn, addnorm, TP_STEPS + 2, TP_STEPS + 2, device),
                "d": tp_want(flash, fab, ffn, addnorm, fwd, bwd, device)}
        log(f"[tp] predicted per rank: (a) {json.dumps(want['a'])}; (b) {json.dumps(want['b'])}; "
            f"(d) {fwd} forward / {bwd} backward passes: {json.dumps(want['d'])}")

        # The two gloo ranks on cuda:0, in their own processes; meanwhile this
        # process runs one process on the sharded layers' route, with the
        # row-parallel sums split as the mesh splits them (what (d) is held
        # to) and unsplit.
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        join_ranks = _ranks_in_background(tp_rank, 2, (root, device, small), TP_TIMEOUT_S)
        try:
            for key, split in (("split_route", True), ("same_route", False)):
                _reset_all(flash, fab, ffn, addnorm)
                _, wall, _ = same_route_run(tables, os.path.join(root, key), device, split)
                info[key] = {"wall_s": wall, "counts": _all_counts(flash, fab, ffn, addnorm)}
            parts["one_process_routes"] = time.perf_counter() - t0
        finally:
            ranks = join_ranks()
        parts["ranks"] = time.perf_counter() - t0
        r0, r1 = ranks
        parts.update({f"rank 0 {k}": v for k, v in r0["parts_s"].items()})
        for r in ranks:
            log(f"[tp] rank {r['rank']}: " + json.dumps(
                {k: v for k, v in r.items() if k not in ("experiment_tail",)}))
        log("[tp] rank 0's report:\n[tp]   " + "\n[tp]   ".join(r0["experiment_tail"]))
        a, a_folded = r0["a"]["same_route"], r0["a"]["folded"]
        (d0, d1), seeds = r0["digests"], r0["seeds"]
        layers = TRAIN_GEO["lab_layers"]
        inner = [3 * i + 1 for i in range(layers)]
        outer = [3 * i + k for i in range(layers) for k in (0, 2)]
        tree = load_params_npz(glob.glob(os.path.join(root, "tp_out", "best_model_*.npz"))[0])
        h = TRAIN_GEO["hidden_size"]
        npz_full = (tree["behrt_lab"]["layer_0"]["ffn_in"]["kernel"].shape == (h, 2048)
                    and tree["behrt_demo"]["bert"]["layer_0"]["attention"]["query"]["kernel"]
                    .shape == (h, h))
        probs, split, same = (_test_probs(os.path.join(root, d))
                              for d in ("tp_out", "split_route", "same_route"))
        diff = float(np.abs(probs - split).max())
        limit = max(DP_ORDER_FACTOR * refs["order_drift"], DP_PRED_FLOOR)
        raw = float(np.abs(probs - same).max())
        diff_folded = float(np.abs(probs - refs["test_probs"]).max())
        route_drift = float(np.abs(same - refs["test_probs"]).max())
        split_drift = float(np.abs(split - same).max())
        # The saved parameters scored with one process's dynamic weights: a
        # threshold step of the weights' statistics moves every probability
        # at once, and is not the parameters' drift (recorded).
        p_same, dw_same = _npz_probs(os.path.join(root, "same_route"), refs["test_arrays"],
                                     device=device)
        p_tp, dw_tp = _npz_probs(os.path.join(root, "tp_out"), refs["test_arrays"], dw_same,
                                 device=device)
        p_split, _ = _npz_probs(os.path.join(root, "split_route"), refs["test_arrays"],
                                dw_same, device=device)
        checks = {
            "(a) eval loss of the sharded parameters vs one process": a["eval_rel"]
            <= TP_EVAL_TOL,
            "(a) step vs one process on the same route": a["loss_rel"] <= XDEV_LOSS_TOL
            and a["worst_grad_rel_flips_set"] <= XDEV_GRAD_TOL
            and a["relu_flips"]["h_at_flip_share"] <= REPLAY_FLIP_TOL,
            "(b) replicated parameters bit-identical across ranks, shards differ": all(
                x[0] == y[0] and x[1] != y[1] for x, y in zip(d0, d1))
            and len({x[0] for x in d0}) == TP_STEPS,
            "(b) backward bit-identical twice": r0["backward_twice_identical"]
            and r1["backward_twice_identical"],
            "(b) #7's inner masks differ between the ranks, the outer masks are equal":
            [f for f, _ in seeds[0]] == [False, True, False] * layers
            and all(seeds[0][i][1] != seeds[1][i][1] for i in inner)
            and all(seeds[0][i][1] == seeds[1][i][1] for i in outer)
            and r0["inner_digests"][0] != r0["inner_digests"][1]
            and r0["outer_digests"][0] == r0["outer_digests"][1]
            and max(r["inner_kernel_vs_plain"] for r in ranks) <= FP32_TOL
            and max(r["outer_kernel_vs_plain"] for r in ranks) <= FP32_TOL,
            "(c) launches of (a), (b) and (d) per rank, and one process on the route": all(
                r["counts_a"] == want["a"] and r["counts_b"] == want["b"]
                and r["counts_d"] == want["d"] for r in ranks)
            and info["same_route"]["counts"] == want["d"],
            "(d) metrics finite": all(np.isfinite(v).all()
                                      for v in r0["experiment"]["metrics"].values()),
            "(d) rank 0 alone writes and prints": bool(r0["experiment"]["artifacts"])
            and not r1["experiment"]["artifacts"] and r1["experiment"]["printed_lines"] == 0,
            "(d) splits": r0["experiment"]["splits"] == refs["splits"],
            "(d) the npz holds full-size parameters": npz_full
            and r0["experiment"]["sharded_leaves"] > 0,
            "(d) test probabilities vs one process summing the same halves": diff <= limit,
        }
        info["artifacts"] = _artifacts(os.path.join(root, "tp_out"))
        info.update(
            checks=checks, test_prob_max_abs=diff, test_prob_limit=limit,
            test_prob_max_abs_vs_folded=diff_folded, order_drift=refs["order_drift"],
            route_drift=route_drift, split_drift=split_drift, test_prob_max_abs_vs_unsplit=raw,
            equal_weights={"vs_split": float(np.abs(p_tp - p_split).max()),
                           "vs_unsplit": float(np.abs(p_tp - p_same).max()),
                           "split_vs_unsplit": float(np.abs(p_split - p_same).max()),
                           "unfolded_vs_folded": refs["order_drift_equal_weights"]},
            dynamic_weights={"two_ranks": dw_tp.tolist(), "one_process": dw_same.tolist(),
                             "max_abs": float(np.abs(dw_tp - dw_same).max())}, a=a,
            a_vs_folded=a_folded, predicted=want,
            memory={"one_process": r0["memory_one_process"],
                    "ranks": [r["memory"] for r in ranks],
                    "experiment_local_param_bytes": [r["experiment"]["local_param_bytes"]
                                                     for r in ranks]},
            step_ms=[r["step"].get("train_step_ms") for r in ranks],
            experiment={"wall_s": [r["experiment"]["wall_s"] for r in ranks],
                        "timings": r0["experiment"]["timings"],
                        "history": r0["experiment"]["history"],
                        "metrics": r0["experiment"]["metrics"]},
            launches={k: [r["counts_d"][k] for r in ranks] for k in r0["counts_d"]},
            seconds_by_part=parts)
        log(f"[tp] checks {json.dumps(checks)}; test probabilities {diff:.3e} from one process "
            f"summing the same halves (limit {limit:.3e}: {DP_ORDER_FACTOR} x the unfolded "
            f"drift {refs['order_drift']:.3e}); {raw:.3e} from one process unsplit on the same "
            f"route (split drift {split_drift:.3e}, route drift {route_drift:.3e}), "
            f"{diff_folded:.3e} from one folded process; with equal dynamic weights "
            f"{json.dumps(info['equal_weights'])}; dynamic weights "
            f"{json.dumps(info['dynamic_weights'])}; (a) "
            f"{json.dumps(a)}, against the folded one {json.dumps(a_folded)}; "
            f"step ms {info['step_ms']}; memory {json.dumps(info['memory'])}")
        if not all(checks.values()):
            raise AssertionError(f"phase 13 failed: {[k for k, v in checks.items() if not v]}")
        info["launches_tp"] = {k: {"rank0": r0["counts_d"][k], "rank1": r1["counts_d"][k]}
                               for k in r0["counts_d"]}
    finally:
        if saved_cache is None:
            os.environ.pop("FMTPU_TEXT_CACHE", None)
        else:
            os.environ["FMTPU_TEXT_CACHE"] = saved_cache
        shutil.rmtree(root, ignore_errors=True)
        if refs.get("text_cache"):
            shutil.rmtree(refs["text_cache"], ignore_errors=True)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_phase
    return info["launches_tp"], info


# -- phase 14: the kernels as torch ops, and FAME's step captured into CUDA graphs --------
#
# A replay must give the eager call's bits: the same kernels run in the same
# order on the same inputs, and the keys they read hold the seeds the eager
# call passes as ints.  No tolerance applies anywhere in this phase.

OPS_GEO = dict(B=2, S=128, H=256, nh=4, F=512)      # opcheck: every kernel's constraints
CAPTURE_GEO = dict(B=2, S=560, H=768, nh=8, F=2048)  # the lab layer at batch 2
CAPTURE_RATE, CAPTURE_REPLAYS = 0.1, 3
CAPTURED_STEPS = (("fp32 B16", torch.float32, 16, 9), ("bf16 B256", torch.bfloat16, 256, 2))
CAPTURE_TIMED, CAPTURE_TURNS = 8, 2


def _randn(gen, shape, dtype, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)


def _lab_mask(gen, b, s):
    mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.2).to(torch.int32)
    mask[:, 0] = 1
    return mask


def _op_inputs(gen, dtype, B, S, H, nh, F):
    f32 = torch.float32
    x = _randn(gen, (B, S, H), dtype)
    w = [_randn(gen, (3 * H, H), dtype, H ** -0.5), _randn(gen, (3 * H,), dtype, 0.05),
         _randn(gen, (H, H), dtype, H ** -0.5), _randn(gen, (H,), dtype, 0.05)]
    ffn = [_randn(gen, (B * S, H), dtype), _randn(gen, (F, H), dtype, H ** -0.5),
           _randn(gen, (F,), dtype, 0.05), _randn(gen, (H, F), dtype, F ** -0.5),
           _randn(gen, (H,), dtype, 0.05)]
    return dict(x=x, w=w, gamma=1.0 + _randn(gen, (H,), f32, 0.1), beta=_randn(gen, (H,), f32, 0.1),
                mask=_lab_mask(gen, B, S), g=_randn(gen, (B, S, H), dtype), ffn=ffn,
                g2=_randn(gen, (B * S, H), dtype),
                qkv=_randn(gen, (B, S, 3 * H), dtype))


def op_cases(fab, ffn, flash, addnorm, gen, dtype, B, S, H, nh, F, rate=CAPTURE_RATE):
    """fm:: op name -> (op, args) on CUDA tensors: each forward with dropout
    on where it draws (keys made by ``device_key``), each backward from its
    forward's residuals."""
    from fairmultimodal_torch.utils.rng import Dropout, device_key

    t = _op_inputs(gen, dtype, B, S, H, nh, F)
    x, w, gamma, beta, mask, g = (t[k] for k in ("x", "w", "gamma", "beta", "mask", "g"))
    key = [device_key(1000 + i, "cuda") for i in range(5)]
    inv = 1.0 / (1.0 - rate)
    cases = {}
    fwd = (x, *w, gamma, beta, mask, key[0], rate, nh, 1e-5, True)
    _, qkv, o, stats, z = fab.attention_block_ln_op(*fwd)
    cases["attention_block_ln"] = (fab.attention_block_ln_op, fwd)
    cases["attention_block_ln_bwd"] = (fab.attention_block_ln_bwd_op, (
        g, x, qkv, o, stats, z, w[0], w[2], gamma, mask, key[0], rate, nh, 1e-5))
    fwd = (x, *w, mask, nh, True)
    _, qkv, o, stats = fab.attention_block_op(*fwd)
    cases["attention_block"] = (fab.attention_block_op, fwd)
    cases["attention_block_bwd"] = (fab.attention_block_bwd_op,
                                    (g, x, qkv, o, stats, w[0], w[2], mask, nh))
    x2, w1, b1, w2, b2 = t["ffn"]
    fwd = (x2, w1, b1, w2, b2, gamma, beta, key[1], key[2], rate, "relu", 1e-5, True)
    _, hd, z2 = ffn.ffn_ln_op(*fwd)
    cases["ffn_ln"] = (ffn.ffn_ln_op, fwd)
    cases["ffn_ln_bwd"] = (ffn.ffn_ln_bwd_op, (t["g2"], x2, hd, z2, w1, w2, gamma, key[2], rate,
                                               inv, "relu", 1e-5))
    fwd = (x2, w1, b1, w2, b2, key[3], rate, "relu", True)
    _, hd = ffn.ffn_op(*fwd)
    cases["ffn"] = (ffn.ffn_op, fwd)
    cases["ffn_bwd"] = (ffn.ffn_bwd_op, (t["g2"], x2, hd, w1, w2, inv, "relu"))
    q, k, v = (u.transpose(1, 2) for u in t["qkv"].view(B, S, 3, nh, H // nh).unbind(2))
    fwd = (q, k, v, mask, True)
    o, stats = flash.flash_attention_op(*fwd)
    cases["flash_attention"] = (flash.flash_attention_op, fwd)
    cases["flash_attention_bwd"] = (flash.flash_attention_bwd_op,
                                    (g.view(B, S, nh, H // nh).transpose(1, 2), q, k, v, o,
                                     stats, mask))
    drop = Dropout.make(key[4], 1, rate)
    fwd = (x, g, gamma, beta, drop.seed, drop.stream, drop.threshold, drop.inv_keep, 1e-5, True)
    _, z3 = addnorm.dropout_add_layernorm_op(*fwd)
    cases["dropout_add_layernorm"] = (addnorm.dropout_add_layernorm_op, fwd)
    cases["dropout_add_layernorm_bwd"] = (addnorm.dropout_add_layernorm_bwd_op, (
        g, z3, gamma, drop.seed, drop.stream, drop.threshold, drop.inv_keep, 1e-5))
    return cases


def opcheck_all(fab, ffn, flash, addnorm):
    """(a): ``torch.library.opcheck`` of every op, fp32 and bf16, on the card."""
    from fairmultimodal_torch.ops import _library

    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = op_cases(fab, ffn, flash, addnorm, gen, dtype, **OPS_GEO)
        if sorted(cases) != sorted(_library.OPS):
            raise AssertionError(f"opcheck cases {sorted(cases)}, ops {sorted(_library.OPS)}")
        for name, (op, args) in cases.items():
            if not name.endswith("_bwd"):
                args = tuple(a.detach().clone().requires_grad_(True)
                             if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                             for a in args)
            t0 = time.perf_counter()
            result = torch.library.opcheck(op, args)
            if set(result.values()) != {"SUCCESS"}:
                raise AssertionError(f"opcheck {name} {dtype}: {result}")
            out[f"{name} {str(dtype)[6:]}"] = round(time.perf_counter() - t0, 2)
    return out


def _capture(run, n_keys):
    """``run(keys)`` captured into a CUDA graph after two warm-up calls on a
    side stream (the first builds, sets kernel attributes and encodes tensor
    maps): its keys are the slots of a device buffer that the graph's first
    node copies from ``host``, pinned memory the caller rewrites before each
    replay.  Returns (graph, the outputs' static tensors, host)."""
    from fairmultimodal_torch.ops import _build

    host = torch.zeros(max(n_keys, 1), dtype=torch.int64, pin_memory=True)
    dev = torch.zeros(max(n_keys, 1), dtype=torch.int64, device="cuda")
    keys = [dev[i] for i in range(n_keys)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            _build.copy_h2d(dev, host)
            run(keys)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _build.copy_h2d(dev, host)
        outs = run(keys)
    return graph, outs, host


def _op_pairs(fab, ffn, flash, addnorm, gen, dtype, B, S, H, nh, F, rate=CAPTURE_RATE):
    """The six op pairs as (name, run, keys, leaves, show, masks): ``run(keys)``
    is the forward op with its residuals and the backward by autograd,
    returning [output, residuals that show a mask, grads...]; ``show()`` sets
    the inputs in place to values that make each mask visible (None for a
    pair that draws none); ``masks`` lists (output index, key index, stream,
    shape) of each mask an output shows."""
    from fairmultimodal_torch.ops import _library
    from fairmultimodal_torch.utils.rng import Dropout

    t = _op_inputs(gen, dtype, B, S, H, nh, F)
    R = B * S

    def leaf(v):
        return v.detach().clone().requires_grad_(True)

    def key_args(keys):
        return [_library.key_of(k, "cuda") for k in keys]

    def grads(out, leaves, g):
        return list(torch.autograd.grad(out, leaves, g))

    def fill(pairs):
        with torch.no_grad():
            for tensor, value in pairs:
                tensor.fill_(value)

    pairs = []
    x, w, gamma, beta = leaf(t["x"]), [leaf(u) for u in t["w"]], leaf(t["gamma"]), leaf(t["beta"])
    mask, g = t["mask"], t["g"]
    ln_leaves = [x, *w, gamma, beta]

    def attention_ln(keys):
        out, _, _, _, z = fab.attention_block_ln_op(*ln_leaves, mask, *key_args(keys), rate, nh,
                                                    1e-5, True)
        return [out, z, *grads(out, ln_leaves, g)]

    pairs.append(("attention_block_ln", attention_ln, 1, ln_leaves,
                  lambda: fill([(x, 0.0), (w[2], 0.0), (w[3], 1.0)]), [(1, 0, 0, (R, H))]))
    block_leaves = [leaf(t["x"]), *[leaf(u) for u in t["w"]]]

    def block(keys):
        out = fab.attention_block_op(*block_leaves, mask, nh, True)[0]
        return [out, *grads(out, block_leaves, g)]

    pairs.append(("attention_block", block, 0, block_leaves, None, []))
    fl = [leaf(u) for u in t["ffn"]]
    fln_leaves = [*fl, leaf(t["gamma"]), leaf(t["beta"])]

    def ffn_ln(keys):
        out, hd, z = ffn.ffn_ln_op(*fln_leaves, *key_args(keys), rate, "relu", 1e-5, True)
        return [out, hd, z, *grads(out, fln_leaves, t["g2"])]

    pairs.append(("ffn_ln", ffn_ln, 2, fln_leaves,
                  lambda: fill([(fl[0], 0.0), (fl[1], 0.0), (fl[2], 1.0), (fl[3], 0.0),
                                (fl[4], 1.0)]),
                  [(1, 0, 0, (R, F)), (2, 1, 1, (R, H))]))
    uf = [leaf(u) for u in t["ffn"]]

    def ffn_unfolded(keys):
        out, hd = ffn.ffn_op(*uf, *key_args(keys), rate, "relu", True)
        return [out, hd, *grads(out, uf, t["g2"])]

    pairs.append(("ffn", ffn_unfolded, 1, uf,
                  lambda: fill([(uf[1], 0.0), (uf[2], 1.0)]), [(1, 0, 0, (R, F))]))
    packed = leaf(t["qkv"])
    gh = g.view(B, S, nh, H // nh).transpose(1, 2)

    def flash_pair(keys):
        q, k, v = (u.transpose(1, 2) for u in packed.view(B, S, 3, nh, H // nh).unbind(2))
        out = flash.flash_attention_op(q, k, v, mask, True)[0]
        return [out, *grads(out, [packed], gh)]

    pairs.append(("flash_attention", flash_pair, 0, [packed], None, []))
    gx, gy = leaf(t["x"]), leaf(t["g"])
    glue_leaves = [gx, gy, leaf(t["gamma"]), leaf(t["beta"])]

    def glue(keys):
        drop = Dropout.make(*key_args(keys), 1, rate)
        out, z = addnorm.dropout_add_layernorm_op(*glue_leaves, drop.seed, drop.stream,
                                                  drop.threshold, drop.inv_keep, 1e-5, True)
        return [out, z, *grads(out, glue_leaves, g)]

    pairs.append(("dropout_add_layernorm", glue, 1, glue_leaves,
                  lambda: fill([(gx, 0.0), (gy, 1.0)]), [(1, 0, 1, (R, H))]))
    return pairs


def op_capture_check(fab, ffn, flash, addnorm, dtype):
    """(b) for one dtype: each op pair captured and replayed against eager."""
    from fairmultimodal_torch.utils.rng import dropout_mask

    gen = torch.Generator(device="cuda").manual_seed(15)
    seeds = torch.Generator().manual_seed(16)
    report = {}
    for name, run, n_keys, leaves, show, masks in _op_pairs(fab, ffn, flash, addnorm, gen,
                                                            dtype, **CAPTURE_GEO):
        graph, outs, host = _capture(run, n_keys)
        kept = []
        for i in range(CAPTURE_REPLAYS):
            if i == 1 and show is not None:
                show()
            elif i > 0:                       # new inputs through the same buffers
                with torch.no_grad():
                    for t in leaves:
                        t.mul_(0.5)
            drawn = [int(s) for s in torch.randint(0, 2 ** 31 - 1, (max(n_keys, 1),),
                                                   generator=seeds)][:n_keys]
            if n_keys:
                host.copy_(torch.tensor(drawn, dtype=torch.int64))
            graph.replay()
            torch.cuda.synchronize()
            got = [t.clone() for t in outs]
            want = run(drawn)
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            if not all(same):
                raise AssertionError(f"{name} {dtype}: replay {i} differs from eager in "
                                     f"outputs {[j for j, s in enumerate(same) if not s]}")
            if i > 0 and show is not None:
                for out_i, key_i, stream, shape in masks:
                    want_mask = dropout_mask(drawn[key_i], stream, shape, CAPTURE_RATE, "cuda")
                    if not torch.equal(got[out_i].reshape(shape) != 0, want_mask):
                        raise AssertionError(f"{name} {dtype}: replay {i}'s mask of output "
                                             f"{out_i} is not dropout_mask's")
                    kept.append(float(want_mask.float().mean()))
        report[name] = {"replays": CAPTURE_REPLAYS, "bit_identical": True,
                        "masks_checked": len(kept),
                        **({"kept_fraction": [round(k, 4) for k in kept]} if kept else {})}
        del graph, outs
    torch.cuda.empty_cache()
    return report


def captured_step_check(dtype, n, seed):
    """(c) and (d) for one configuration: FAME's step up to the clip,
    captured with a KeyTape, against the eager step; then both timed."""
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
    from fairmultimodal_torch.utils.rng import KeyTape

    trainer = FAMETrainer(init_params(FAMEModel(**TRAIN_GEO, dtype=dtype), seed=0),
                          TrainConfig(lr=1e-4, batch_size=n), pos_weight=POS_WEIGHT,
                          rngs_seed=0, device="cuda")
    a = synthetic_cohort(np.random.default_rng(seed), n)
    keys = [k for k in a if k != "labels"]
    batch = to_device({"model_inputs": {k: a[k] for k in keys}, "labels": a["labels"],
                       "weight": np.ones(n, np.float32)}, trainer.device)
    dyn_w = trainer._dyn_w()
    gen = trainer._dropout_rng
    params = [p for group in trainer.optimizer.param_groups for p in group["params"]]

    def step(generator):
        """``FAMETrainer.train_step`` without its AdamW update."""
        trainer._dropout_rng = generator
        total, bce = trainer.backward(batch, dyn_w)
        torch.nn.utils.clip_grad_norm_(trainer.model.parameters(), trainer.config.grad_clip)
        return total, bce

    tape = KeyTape(gen, "cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(tape)                            # records the step's dropout sites
        tape.redraw().upload()
        step(tape)                            # a pass that reads its keys from the tape
    torch.cuda.current_stream().wait_stream(side)
    tape.redraw()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tape.upload()
        total, bce = step(tape)
    static = [total, bce] + [p.grad for p in params]
    res = {"dropout_sites": len(tape.sites), "replays": CAPTURE_REPLAYS}
    for i in range(CAPTURE_REPLAYS):
        state = gen.get_state()
        want = list(step(gen)) + [p.grad.clone() for p in params]
        gen.set_state(state)
        tape.redraw()
        graph.replay()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(static, want)]
        if not all(same):
            bad = [j for j, s in enumerate(same) if not s]
            raise AssertionError(f"captured step {dtype} B{n}, replay {i}: {len(bad)} of "
                                 f"{len(same)} tensors differ from eager (first {bad[:5]})")
        if i == 0:
            res["loss"] = float(want[0])
    res["bit_identical"] = True

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    turns = {"eager_ms": [], "replay_ms": []}
    for _ in range(CAPTURE_TURNS):
        turns["eager_ms"].append(statistics.median(timed(lambda: step(gen))
                                                   for _ in range(CAPTURE_TIMED)))
        replays = []
        for _ in range(CAPTURE_TIMED):
            tape.redraw()
            replays.append(timed(graph.replay))
        turns["replay_ms"].append(statistics.median(replays))
    res.update(turns)
    del graph, static, trainer, batch
    torch.cuda.empty_cache()
    return res


def ops_capture_phase(fab, ffn, flash, addnorm):
    """Phase 14: (a) opcheck, (b) the op pairs captured, (c, d) the steps."""
    t0 = time.perf_counter()
    info = {"opcheck_s": opcheck_all(fab, ffn, flash, addnorm)}
    info["seconds_by_part"] = {"opcheck": time.perf_counter() - t0}
    log(f"[ops] opcheck, every op and dtype passed: {json.dumps(info['opcheck_s'])}")
    t0 = time.perf_counter()
    info["op_pairs"] = {str(dt)[6:]: op_capture_check(fab, ffn, flash, addnorm, dt)
                        for dt in (torch.float32, torch.bfloat16)}
    info["seconds_by_part"]["op_pairs"] = time.perf_counter() - t0
    log(f"[ops] op pairs captured: {json.dumps(info['op_pairs'])}")
    info["steps"] = {}
    for label, dtype, n, seed in CAPTURED_STEPS:
        t0 = time.perf_counter()
        info["steps"][label] = captured_step_check(dtype, n, seed)
        info["seconds_by_part"][label] = time.perf_counter() - t0
        log(f"[ops] captured step {label}: {json.dumps(info['steps'][label])}")
    return info


def share_bytecode():
    """Let this process, and every Python process it starts, keep compiled
    bytecode under ``build/pycache`` in this checkout.  Where the environment
    sets PYTHONDONTWRITEBYTECODE, each fresh process compiles every module it
    imports (on an H100 host: ~6.5 s for torch, ~8 s for its dynamo package,
    which the optimizer's first step imports), and phases 11-13's child
    processes and gloo ranks paid that each time.  Spawned ranks still get
    ``-B`` from this process's startup flags: they read the cache and write
    nothing."""
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    os.makedirs(prefix, exist_ok=True)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    share_bytecode()
    from fairmultimodal_torch.ops import _build
    from fairmultimodal_torch.ops import dropout_add_layernorm as addnorm
    from fairmultimodal_torch.ops import flash_attention as flash
    from fairmultimodal_torch.ops import fused_attention_block as fab
    from fairmultimodal_torch.ops import fused_ffn as ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    _build.kernels()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(_build)
    log(f"[build] ptxas -v of the redesigned kernels: {json.dumps(ptxas)}")
    log(f"[build] layernorm_bwd_kernel blocks an SM at H 768: "
        f"{json.dumps(ln_bwd_occupancy(_build, ptxas))}")

    summary = []

    def phase(label, fn, numbers=lambda out: {}):
        """Run one phase, log its seconds, keep its summary line."""
        t0 = time.perf_counter()
        try:
            out = fn()
        except BaseException:
            summary.append(f"[summary] {label}: FAILED after {time.perf_counter() - t0:.1f} s")
            print("\n".join(summary), flush=True)
            raise
        secs = time.perf_counter() - t0
        summary.append(f"[summary] {label}: ok, {secs:.1f} s"
                       + "".join(f", {k} {v}" for k, v in numbers(out).items()))
        log(f"[phase] {label}: {secs:.1f} s")
        return out

    def step_ms(info):
        """{route: [each turn's median step ms]} of a phase's step timings."""
        return {k: [round(t["train_step_ms"], 1) for t in v]
                for k, v in info.get("train_step", {}).items()}

    rows = phase("3 kernels", lambda: kernel_phase(fab, ffn))
    train_rows, keep = phase("3b training kernels", lambda: train_kernel_phase(fab, ffn, _build))
    unfolded_rows = phase("3c unfolded kernels", lambda: unfolded_kernel_phase(fab, ffn, addnorm))
    phase("3c GEMM stages", lambda: (nt_gemm_phase(_build), nn_tn_gemm_phase(_build, fab),
                                     f32_gemm_phase(_build, fab)))
    flash_rows, flash_layer = phase("3d flash kernels", lambda: flash_kernel_phase(flash))
    launches, slice_info = phase("4 serving slice", lambda: slice_phase(fab, ffn))
    log(f"[slice] {json.dumps(slice_info)}")
    train_launches, train_info = phase("5 training slice", lambda: train_slice_phase(fab, ffn))
    log(f"[train] {json.dumps(train_info)}")
    unfolded_launches, unfolded_info = phase(
        "5b unfolded slice", lambda: unfolded_slice_phase(fab, ffn, addnorm),
        lambda out: {"train step ms": step_ms(out[1])})
    log(f"[unfolded] {json.dumps(unfolded_info)}")
    flash_launches, flash_info = phase(
        "5c flash-route slice", lambda: flash_slice_phase(flash, fab, ffn, addnorm),
        lambda out: {"train step ms": step_ms(out[1])})
    log(f"[flash] {json.dumps(flash_info)}")
    experiment_launches, experiment_info = phase(
        "6 experiment", lambda: experiment_phase(flash, fab, ffn, addnorm))
    log(f"[experiment] {json.dumps(experiment_info)} | {smi}")
    cli_launches, cli_info = phase("7 command line", lambda: cli_phase(flash, fab, ffn, addnorm))
    log(f"[cli] {json.dumps(cli_info)} | {smi}")
    base_launches, base_rows, base_info = phase(
        "8 baselines", lambda: baseline_phase(flash, fab, ffn, addnorm, _build))
    log(f"[baselines] {json.dumps(base_info)} | {smi}")
    legacy_launches, clp_rows, legacy_info = phase(
        "9 remaining baselines", lambda: legacy_phase(flash, fab, ffn, addnorm, _build),
        lambda out: {"seconds by part": json.dumps(
            {k: round(v, 1) for k, v in out[2]["seconds_by_part"].items()})})
    log(f"[legacy] {json.dumps(legacy_info)} | {smi}")
    adv_launches, adv_info = phase("10 adv_debias", lambda: adv_debias_phase(flash, fab, ffn,
                                                                            addnorm))
    log(f"[adv] {json.dumps(adv_info)} | {smi}")
    etl_launches, etl_info = phase("11 ETL", lambda: etl_phase(flash, fab, ffn, addnorm))
    log(f"[etl] {json.dumps(etl_info)} | {smi}")
    refs = {}
    dp_launches, dp_info = phase(
        "12 data parallelism", lambda: dp_phase(flash, fab, ffn, addnorm, keep=refs),
        lambda out: {"two ranks vs one process |p|": f"{out[1]['test_prob_max_abs']:.3e}",
                     "limit": f"{out[1]['test_prob_limit']:.3e}",
                     "seconds by part": json.dumps({k: round(v, 1) for k, v in
                                                    out[1]["seconds_by_part"].items()})})
    log(f"[dp] {json.dumps({k: v for k, v in dp_info.items() if k != 'ranks'})} | {smi}")
    tp_launches, tp_info = phase(
        "13 tensor parallelism", lambda: tp_phase(flash, fab, ffn, addnorm, refs=refs),
        lambda out: {"eval rel": f"{out[1]['a']['eval_rel']:.2e}",
                     "worst grad vs folded": f"{out[1]['a_vs_folded']['worst_leaf']} "
                                             f"{out[1]['a_vs_folded']['worst_grad_rel']:.2e}",
                     "step loss rel": f"{out[1]['a']['loss_rel']:.2e}",
                     "worst grad": f"{out[1]['a']['worst_leaf']} "
                                   f"{out[1]['a']['worst_grad_rel']:.2e}",
                     "relu flips": out[1]["a"]["relu_flips"]["flips"],
                     "worst grad, their rows set": f"{out[1]['a']['worst_leaf_flips_set']} "
                                                   f"{out[1]['a']['worst_grad_rel_flips_set']:.2e}",
                     "|p| vs one process": f"{out[1]['test_prob_max_abs']:.3e} "
                                           f"(limit {out[1]['test_prob_limit']:.3e}; folded "
                                           f"{out[1]['test_prob_max_abs_vs_folded']:.3e})",
                     "step ms per rank": [round(v, 1) for v in out[1]["step_ms"] if v],
                     "param bytes per rank / one process": [
                         out[1]["memory"]["ranks"][0]["param_bytes"],
                         out[1]["memory"]["one_process"]["param_bytes"]],
                     "seconds by part": json.dumps({k: round(v, 1) for k, v in
                                                    out[1]["seconds_by_part"].items()})})
    log(f"[tp] {json.dumps(tp_info)} | {smi}")
    ops_info = phase(
        "14 ops and CUDA graphs", lambda: ops_capture_phase(fab, ffn, flash, addnorm),
        lambda out: {"opcheck cases": len(out["opcheck_s"]),
                     "op pairs bit-identical over replays": sum(
                         len(v) for v in out["op_pairs"].values()),
                     "steps eager / replay ms": {k: [[round(t, 2) for t in v["eager_ms"]],
                                                     [round(t, 2) for t in v["replay_ms"]]]
                                                 for k, v in out["steps"].items()},
                     "seconds by part": json.dumps({k: round(v, 1) for k, v in
                                                    out["seconds_by_part"].items()})})
    log(f"[ops] {json.dumps(ops_info)} | {smi}")

    meta = {
        "fused_attention_block_ln": ("fairmultimodal_torch/ops/csrc/flash_attention.cu",
                                     "fairmultimodal_tpu/ops/fused_attention_block.py:517"),
        "fused_ffn_ln": ("fairmultimodal_torch/ops/csrc/gemm.cu",
                         "fairmultimodal_tpu/ops/fused_ffn.py:414"),
    }
    timed_train = {"fused_attention_block_ln": next(r for r in train_rows["attention"]
                                                    if "ms" in r),
                   "fused_ffn_ln": next(r for r in train_rows["ffn"] if "ms" in r)}
    kernels = []
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = mine[0]    # the lab-encoder shape of the serving batch, bf16
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": main["max_abs_err_bf16"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "dtype": "bfloat16", "stages_ms": main["stages_ms"],
            "sources": ["fairmultimodal_torch/ops/csrc/gemm.cu",
                        "fairmultimodal_torch/ops/csrc/flash_attention.cu",
                        "fairmultimodal_torch/ops/csrc/add_layernorm.cu"]
            if name == "fused_attention_block_ln" else
            ["fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_torch/ops/csrc/add_layernorm.cu"],
            "launches_by_encoder": {"text": slice_info["text"][name],
                                    "lab": slice_info["lab"][name]},
            "launches_training": train_launches[name],
            "launches_experiment": experiment_launches[name],
            "launches_cli": cli_launches[name],
            "launches_baselines": base_launches[name], "baselines_b16": base_rows[name],
            "launches_legacy": legacy_launches[name],
            **({"clp_r8784_h256_f512": clp_rows[name]} if name in clp_rows else {}),
            "fwd_res_dropout_ms": timed_train[name]["fwd_res_ms"],
            "shapes": mine,
        })
    for name, part, source, replaces in (
            ("fused_attention_block_ln_bwd", "attention",
             "fairmultimodal_torch/ops/csrc/flash_attention.cu",
             "fairmultimodal_tpu/ops/fused_attention_block.py:657"),
            ("fused_ffn_ln_bwd", "ffn", "fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_tpu/ops/fused_ffn.py:530")):
        row = timed_train[name[:-4]]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[name], "max_abs_err": row["errors"]["dx"]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "stages_ms": row["stages_ms"], "shape": row["case"], "dtype": "bfloat16",
            "sources": ["fairmultimodal_torch/ops/csrc/add_layernorm.cu",
                        "fairmultimodal_torch/ops/csrc/gemm.cu"]
            + (["fairmultimodal_torch/ops/csrc/flash_attention.cu"] if part == "attention"
               else []),
            "errors": {r["case"]: r["errors"] for r in train_rows[part]},
            "kept_fraction": keep, "launches_experiment": experiment_launches[name],
            "launches_cli": cli_launches[name],
            "launches_baselines": base_launches[name], "baselines_b16": base_rows[name],
            "launches_legacy": legacy_launches[name],
            **({"clp_r8784_h256_f512": clp_rows[name]} if name in clp_rows else {}),
        })
    sources = {"block": ["fairmultimodal_torch/ops/csrc/gemm.cu",
                         "fairmultimodal_torch/ops/csrc/flash_attention.cu"],
               "ffn": ["fairmultimodal_torch/ops/csrc/gemm.cu"]}
    for name, part, source, replaces, bwd in (
            ("fused_attention_block", "block", "fairmultimodal_torch/ops/csrc/flash_attention.cu",
             "fairmultimodal_tpu/ops/fused_attention_block.py:150", False),
            ("fused_attention_block_bwd", "block",
             "fairmultimodal_torch/ops/csrc/flash_attention.cu",
             "fairmultimodal_tpu/ops/fused_attention_block.py:250", True),
            ("fused_ffn", "ffn", "fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_tpu/ops/fused_ffn.py:122", False),
            ("fused_ffn_bwd", "ffn", "fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_tpu/ops/fused_ffn.py:205", True)):
        row = next(r for r in unfolded_rows[part] if "ms" in r)     # lab shape, bf16
        pre = "bwd_" if bwd else ""
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": unfolded_launches[name],
            "max_abs_err": row["errors"]["dx"]["max_abs_err"] if bwd else
            row["forward"]["max_abs_err"],
            "ms": row[pre + "ms"], "plain_ms": row["plain_" + pre + "ms"],
            "bound_ms": row[pre + "bound_ms"], "bound_by": row[pre + "bound_by"],
            "library_ms": row["library_" + pre + "ms"], "stages_ms": row[pre + "stages_ms"],
            "shape": row["case"], "dtype": "bfloat16", "sources": sources[part],
            "errors": {r["case"]: {"forward": r["forward"], **r["errors"]}
                       for r in unfolded_rows[part]},
            "baselines_b16": base_rows[name],
        })
    row = next(r for r in flash_rows if "ms" in r and "bfloat16" in r["case"])   # lab, bf16
    f32_rows = {r["case"]: {k: r[k] for k in ("ms", "fwd_res_ms", "plain_ms", "library_ms",
                                               "library_kernels", "bound_ms", "bound_by")}
                for r in flash_rows if "ms" in r and "float32" in r["case"]}
    errors = {r["case"]: r["errors"] for r in flash_rows}
    for name, replaces, pre, outs in (
            ("flash_attention", "fairmultimodal_tpu/ops/flash_attention.py:44", "", ("o",)),
            ("flash_attention_bwd", "fairmultimodal_tpu/ops/flash_attention.py:67", "bwd_",
             FLASH_GRADS)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fairmultimodal_torch/ops/csrc/flash_attention.cu", "replaces": replaces,
            "launches": flash_launches[name],
            "max_abs_err": max(row["errors"][n]["max_abs_err"] for n in outs),
            "ms": row[pre + "ms"], "plain_ms": row["plain_" + pre + "ms"],
            "bound_ms": row[pre + "bound_ms"], "bound_by": row[pre + "bound_by"],
            "library_ms": row["library_" + pre + "ms"], "shape": row["case"],
            "dtype": "bfloat16", "errors": errors, "baselines_b16": base_rows[name],
            **({"fwd_res_ms": row["fwd_res_ms"], "fused_qkv_layer": flash_layer,
                "float32": f32_rows} if not pre
               else {"stages_ms": row["bwd_stages_ms"],
                     "kernel_order": row["kernel_order"]}),
        })
    for row in kernels:
        row["launches_adv_debias"] = adv_launches[row["name"]]
        row["launches_etl"] = etl_launches[row["name"]]
        row["launches_dp"] = dp_launches[row["name"]]
        row["launches_tp"] = tp_launches[row["name"]]
    for name, check in (("flash_attention", "flash"), ("fused_ffn", "ffn")):
        row = next(r for r in kernels if r["name"] == name)
        row["tp_shape"] = {k: tp_info["kernels"][check].get(k) for k in (
            "case", "ms", "bwd_ms", "plain_ms", "library_ms", "bound_ms", "bwd_bound_ms")}
    total_s = time.perf_counter() - t_start
    log(f"[done] {total_s:.1f} s")
    # The full rows (errors by case, stages, every shape) go to a file; the
    # line keeps what each kernel is held to, so it and the summary fit the
    # tail of the output that a caller sees.
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_kernels.json"), "w") as f:
        json.dump({"kernels": kernels, "card": smi, "total_s": total_s}, f)
    compact = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms", "shape", "dtype", "launches_training",
               "launches_experiment", "launches_cli", "launches_baselines", "launches_legacy",
               "launches_adv_debias", "launches_etl", "launches_dp", "launches_tp", "tp_shape")
    print(json.dumps({"kernels": [{k: r[k] for k in compact if k in r} for r in kernels]}))
    print("\n".join(summary + [f"[summary] total: {total_s:.1f} s"]))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
