#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card (it
refuses to run without one). It builds the port's CUDA kernels from
ambersim_tpu_torch/csrc/, holds each against its plain PyTorch version on
the card, and steps every ported path through the port's entry points:

  * the main path, the 4096-env quadruped PD rollout (bench.py:62-127);
  * cartpole and arm3 at 1024 envs x 50 steps (benchmarks/ladder.py:98-102,
    cut in depth), whose rows go to the dense Newton kernel;
  * the quadruped compiled with elliptic cones at 4096 envs x 50 steps
    (benchmarks/elliptic_gap.py:30-35), through the elliptic Newton kernel;
  * the humanoid at 1024 envs x 20 steps, through the structured kernel at
    nv = 25;
  * the 32-body clutter scene (nv = 192) at 256 envs, broadphase-capped
    with and without the max_contact_points row cap (benchmarks/ladder.py
    rungs 3b and 3c), through kernels 1-3 past n = 32 (one thread block per
    system) and the large-nv Newton route;
  * PPO training of the 4096-env quadruped locomotion policy, one training
    step at bench.py:142-177's settings, through kernels 1-4;
  * PPO on the pendulum swingup at examples/rl/pendulum/ex_agents.py's
    settings, which must learn;
  * BASELINE.md:13's predictive-sampling workload on the Barrett-class
    hand (100 samples x 10 knots, Newton 1 x 4 iterations, contacts
    disabled), its four joint equality rows through kernel 4, then MPC on
    it (run_mpc, and run_mpc_batch over 8 initial states);
  * the hand with contacts on, 1024 envs x 100 steps under a closing ctrl,
    so its capsule, sphere and box geoms meet;
  * PPO on humanoid_balance at benchmarks/ladder.py:194-219's settings,
    one training step;
  * the rest of benchmarks/ladder.py, so that every line it prints has a
    path here: drop_scene and the rock drop (mesh collision) at 2048 envs
    x (300 settle + 150 steps), exact clutter (no cap, nefc 5664) and the
    row-capped clutter with Option.hessian_bf16 at 256 envs from the
    row-capped path's settled state, the humanoid's predictive sampling
    (64 samples x 8 knots) and the pendulum at a batch of one;
  * model I/O: the port's own compiler (ambersim_tpu_torch.mjcf) on this
    machine, every committed asset compiled from its MJCF and held against
    its .npz, the main path run from the compiled quadruped; the gripper
    URDF of tests/test_model_io.py (a mimic joint, a forced floating base)
    at 1024 envs x 100 steps; and models/hand/grasp_scene.xml, the mesh
    hand closing on a free mesh object, 300 steps at the largest batch its
    mesh-mesh collision memory allows;
  * gradients through the kernels: each kernel route's Function (the
    kernel forward, autograd through its plain version backward) against
    the plain version's gradient on the CPU, with its backward's time
    (grad_kernels); d(sum qpos + sum qvel)/d(ctrl) through T steps of six
    models, card against CPU (grad_paths); APG on the pendulum
    (examples/rl/pendulum/ex_agents.py's settings, cut) and one APG
    update of the 4096-env locomotion policy; iLQR on the pendulum
    (examples/trajopt/ex_ilqr.py's first task); gradient shooting and iLQR
    on the hand at BASELINE.md:13's 10 knots;
  * height fields: quadruped_terrain (the quadruped over a 24 x 24 height
    field generated from examples/rl/quadruped/ex_terrain.py's seed, its
    scene compiled here by the port) at 4096 envs x 100 steps from seeded
    xy over its relief through kernels 1-4 at nefc 296, held above the
    terrain's surface, and one PPO training step of it at ex_terrain.py's
    settings; ray() against every geom type, a convex mesh and the
    terrain, card against CPU;
  * the gradient-free and off-policy trainers (section 9): ES, ARS and SAC
    on the pendulum at examples/rl/pendulum/ex_agents.py's settings (cut
    in depth), each with a first update (ES, ARS) or the first SGD steps
    (SAC) card against CPU; ES at population 512 on the locomotion task,
    each env acting with its own params; SAC on the locomotion task with
    its 1,000,000-transition replay buffer on the card;
  * sensors and servos: quadruped_sensors, the main path's quadruped with
    an IMU, encoders, foot touch and contact sensors (52 sensors) and its
    motors made position servos, at 4096 envs x 100 steps through kernels
    1-4, its encoders held to its state, its servo rollout to the PD
    path's, its sensors card against CPU on the same Data and over 20
    steps; the sensor rigs of the JAX package's tests (sensors, contact
    sensors, distance, rangefinder) and this script's actuator and mocap
    fixtures, card against CPU;
  * tendons and muscles: muscle_arm, examples/ex_muscle_tendon.py's arm (a
    spatial tendon wrapped on a cylinder, FLV muscles on it and on the
    shoulder) at 4096 envs x 300 steps of the example's excitation
    through kernels 1, 2, 3 and 5, its tendon shortening under the
    excitation, and the example's predictive sampling (64 samples x 100
    knots, 3 calls); tendon_rig, the JAX tests' TENDON_RIG (a tendon
    equality, friction and limit row and a contact) at 4096 x 100
    through kernels 1-4; kernels 4 and 5 held on those paths' final
    operands; the JAX tests' spatial, pulley, limit-sensor, muscle and
    tendon rigs card against CPU;
  * welds, transmissions and pairs: mocap_weld, tests/test_mocap.py's box
    welded to a mocap target, at 4096 envs x 100 steps toward seeded
    targets through kernels 1, 2 and 5 (six equality rows); mocap_drag,
    the same box resting on a floor and dragged over it, through kernels
    1, 2 and 4 (six equality rows and four contacts); refsite_arm,
    tests/test_refsite.py's arm servoed by three refsite actuators, at
    4096 x 300 through kernels 1-4; the boxes at their targets and the
    arm's lengths shrunk; kernels 4 and 5 held on the weld paths' final
    operands; iLQR on a ball joint (tests/trajopt/test_ilqr.py's manifold
    case); the JAX tests' connect, weld, ball-limit, transmission (site,
    slider-crank, adhesion, ball joint) and explicit-pair or OVERRIDE
    fixtures card against CPU, with moments, lengths and efc rows from the
    same Data;
  * contacts of condim 4 and 6 and the integrators, each at 4096 envs from
    the main path's start under its PD controller: soft_feet, the quadruped
    with condim-4 feet (torsional friction), 100 steps through kernels 1,
    2, 3 and 5 (nefc 144); soft_feet_elliptic, the same compiled with
    elliptic cones (condims 3 and 4 mixed), 50 steps through the general
    elliptic solve, its Hessian solves through kernel 3 (no Newton kernel,
    as in the JAX package); condim6_elliptic, every pair condim 6 with
    elliptic cones, 100 steps through kernel 6 at cdim 6 (nefc 192);
    quadruped_implicitfast (50 steps, kernel 3 its solve), quadruped_implicit
    (25 steps, an LU) and quadruped_rk4 (12 steps, kernels 1, 2 and 4 four
    times a step); kernel 5 held on soft_feet's final operands, kernel 6 on
    condim6_elliptic's and on tests/test_elliptic.py's spin-down sphere
    (cdim 4) at 4096 envs, kernel 3 on the general solve's last Hessian and
    on implicitfast's system;
  * the CG solver and the noslip pass, each at 4096 envs x 50 steps from
    the main path's start under its PD controller: quadruped_cg (the
    quadruped loaded with solver="CG", kernel 2 five times a step: M^-1
    once before the CG loop and once in each of its 3 iterations) and
    quadruped_noslip (noslip_iterations 3 after the Newton solve, kernel 2
    once more a step over the 136 efc rows of J, k = 136 right-hand sides
    per env); kernel 2 with k right-hand sides against its plain version
    (warp and block designs), on CG's M^-1 g and noslip's M^-1 J^T; the
    JAX tests' noslip scene, BALL_PLANE under CG, FWDINV, inverse dynamics
    and the support functions card against CPU;
  * fluid forces, gravity compensation, cameras and lights, and per-env
    Model leaves, each at 4096 envs x 50 steps from the main path's start
    under its PD controller through kernels 1-4: quadruped_fluid, the
    quadruped in tests/test_fluid.py's medium under implicitfast (kernel 3
    on qM - h D with the fluid drag's derivative) with gravcomp on its
    legs, a trackcom camera, a targetbody light and four CAMPROJECTION
    sensors of its feet, its frames, pixels and passive force card against
    CPU on the same Data; quadruped_dr, the quadruped with per-env trunk
    mass, leg damping, foot friction and motor gains (rl.quadruped.
    randomize_quadruped), 8 of its envs each against its own unbatched
    model on the card; and ppo_quadruped_dr, one PPO training step of the
    locomotion task with that randomization_fn, the eval envs drawing
    their own leaves.

For each path it checks that every step went through the path's kernels
and compares 8 envs of the rollout on the card with the same rollout on the
CPU (plain versions), and the quadruped's (flat and terrain) and the
humanoid's envs' obs, reward and done likewise. It
also checks that the clutter scene's broadphase and row-cap selections move
geom ids above 256 and contact distances bit for bit with TF32 on. It
imports nothing of JAX. Output: progress lines, a JSON line of per-kernel
results (launches on the paths, error against the plain version, ms beside
the plain version's, the library call's where PyTorch has one, and the
bound: bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the
H100 SXM's published peaks, and the time of its Function's backward), the
card's name and power limit, and as the
last line {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}. Any failed check exits non-zero without that line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

NUM_ENVS = 4096
NUM_STEPS = 100
KP, KD = 60.0, 2.0
LINALG_TOL = 1e-5  # tests/test_linalg_pallas.py:31
# Kernels 1-3 past n = 32 against their plain versions: the bars of the JAX
# package's n = 192 tests (tests/test_linalg_pallas.py:76-98); an n-column
# float32 sweep rounds n times as often as an 18-column one.
LARGE_LINALG_TOL = 2e-4
# n = 100 and 191 are not multiples of the block kernels' 16-wide tiles
LARGE_NS = (33, 64, 65, 100, 128, 191, 192)
# more systems than the 264 that fit on 132 SMs at two blocks an SM
LARGE_BATCH = 1000
# systems at the clutter width whose row and column j are zero: the 1e-12
# pivot clamp makes L_jj = 0 there, on the card as in the plain version
ZERO_PIVOT_ROWS = (0, 17, 100, 191)
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# cuda_ms's sleep before each timed run: ~2 ms at the H100's clocks, longer
# than the host takes to enqueue ten calls of a kernel's wrapper
SLEEP_CYCLES = 4_000_000
# plain_ms's reps x calls: a plain version's time is its host's dispatch pace
# (tens of ms a call), as steady over nine calls as over a hundred; cut from
# cuda_ms's 10 x 10 to make room for the weld phases
PLAIN_REPS, PLAIN_CALLS = 3, 3
# The clutter scene at benchmarks/ladder.py's width (rungs 3b and 3c):
# 256 envs, CLUTTER_SETTLE steps of settling, CLUTTER_STEPS timed steps.
# Cut: both paths start from the committed settled state (CLUTTER_SETTLED,
# where their Newton spread check and the gradient path start too) and
# settle 20 steps there, instead of 400 from rest (the ladder's own settle).
# The cap-48 path times CAP48_STEPS (100 until the tendon phases came, 50
# until the weld phases came): nothing reads its final state but its stage
# split. The rowcap192 path times CLUTTER_STEPS (100 until the fully
# randomized quadruped's phases came): its final state starts the exact and bf16
# paths and its own spread check, all from a state the CPU settled 600
# steps.
CLUTTER_ENVS = 256
CLUTTER_SETTLE = 20
CLUTTER_STEPS = 50
CAP48_STEPS = 25
FLOOR_TOL = 0.005  # no geom below the floor by more than 5 mm after the settle
CLUTTER_CARD_VS_CPU_STEPS = 5
# the quadruped envs' (flat and terrain) card-vs-CPU control steps, 4
# physics steps each (10 until the tendon phases came)
ENV_CONTROL_STEPS = 5
# Fixed operands of the clutter Newton spread check: one env of
# clutter32_rowcap192 settled 600 steps on the CPU (tools/settle_clutter.py),
# the start of both clutter models (one scene, one nq and nv). Their bars,
# (max, median) over the 256 envs of the env-relative distance from float64
# (clutter_newton_spread), set from the spread measured on these operands
# on an NVIDIA H100 (700 W): rowcap192's route max 5.9e-3 and median
# 1.4e-5, plain float32 the same (5.9e-3, 1.3e-5); cap48's route the same
# (5.9e-3, 1.4e-5), plain float32 5.9e-3 and 1.8e-6. A route that rounds
# like float32 stays within about three times the worst and seven times
# the median; a fault in it (a wrong factor, a dropped row) moves every env.
# benchmarks/ladder.py rungs 3 and 3a (:104-112): drop_scene and the rock
# drop at 2048 envs, 300 settle steps and 150 timed steps. Not cut: kernel
# 4 is held on drop_scene's final state (check_newton_ladder), and after
# 300 + 100 steps it met float64 on 0.1357 of envs against plain float32's
# 0.7266 (an NVIDIA H100 80GB HBM3, 700 W), where after 300 + 150 it
# meets it on all
DROP_ENVS, DROP_SETTLE, DROP_STEPS = 2048, 300, 150
# Rungs 3b exact (clutter32 with no cap, :123-125) and 3d (rowcap192 with
# Option.hessian_bf16, :145-148) at the ladder's 256 envs. Cut: both start
# from the rowcap192 path's settled state; exact clutter settles
# EXACT_SETTLE more steps at its own rows (100 until the fully randomized
# quadruped's phases came), then EXACT_STEPS timed steps; bf16 runs
# BF16_STEPS timed steps (the ladder: 400 settle + 100 timed)
EXACT_SETTLE, EXACT_STEPS, BF16_STEPS = 50, 20, 20
# rung 5's humanoid predictive sampling (:160-184): 64 samples x 8 knots,
# Q 0.1 I, Qf 10 I, R 1e-4 I, goal and start at (qpos0, 0), stdev 0.2.
# Cut: 3 optimize calls (20 until the sensor phases came, 10 until the
# tendon phases came, 5 until the weld phases came)
HUMANOID_SAMPLES, HUMANOID_HORIZON, HUMANOID_STDEV = 64, 8, 0.2
HUMANOID_OPTIMIZE_CALLS = 3
# rung 2 (:98-102): cartpole and arm3 at 1024 envs. Cut: 50 steps (200
# until the tendon phases came, 100 until the fluid and per-env-leaf
# phases came; check_newton_dense rolls its own 100)
LADDER_STEPS = 50
# the elliptic quadruped's path: 50 steps (NUM_STEPS until the fluid and
# per-env-leaf phases came; nothing reads its final state)
ELLIPTIC_STEPS = 50
# rung 1 (:94-96): the pendulum, a batch of one, 1000 steps. Cut: 125
# steps (1000 until section 9 came, 500 until the sensor phases came)
PENDULUM_STEPS = 125
# mesh_mesh_memory's pairs: the rock against itself, whose SAT projects
# 34,596 edge axes on 2 x 64 vertices a pair
MESH_MESH_PAIRS = 16
CLUTTER_SETTLED = REPO / "ambersim_tpu_torch" / "assets" / "clutter32_rowcap192_settled.npz"
CLUTTER_SPREAD_BARS = {"clutter32_rowcap192": (2e-2, 1e-4), "clutter32_cap48": (2e-2, 1e-4)}
# absolute floors under the clutter card-vs-CPU bars (10 x the card's own
# spread): far below the 4.9e-4 m a body with no contact force falls in
# 5 steps, and the 1e-2 m/s that a 10% contact-force error makes
CLUTTER_QPOS_EPS, CLUTTER_QVEL_EPS = 1e-6, 1e-5
# Kernels 4 and 5 against their plain version: the bar of
# tests/test_newton_pallas.py (rtol/atol 1e-4 elementwise) must hold on at
# least 99% of the envs, and every env must agree within 5% of its largest
# |component|. The tail is float32 rounding, not the kernel: the
# 3-iteration solve's take/keep and row-activity decisions flip on it, so
# on 4096 quadruped envs the plain version in float32 misses its own
# float64 run in as many envs as the kernel misses the plain version
# (check_newton prints both), while a layout or row-family fault breaks
# nearly every env.
NEWTON_TOL = 1e-4
NEWTON_MIN_SHARE = 0.99
NEWTON_ENV_RTOL = 0.05
# Kernel 6 against its plain version. The guarded bracketed line search
# turns float32 rounding into different bracket states within a few steps
# (a Newton step that rounds onto the bracket's end is replaced by the
# midpoint), so at the model's 3 x 6 iterations the plain solve in float32
# meets its own float64 run on under half of the envs at 1e-4. It
# is held where the solve is not chaotic. With one line-search step per
# iteration, the NEWTON_* share and per-env bars hold at ELLIPTIC_ENV_TOL of
# each env's largest |component|. Converged (15 x 15, as
# tests/test_newton_pallas.py:255 converges both paths), they hold at
# ELLIPTIC_CONVERGED_TOL (that test's rtol 1e-2: converged iterates stop at
# different points of a flat valley), and the kernel's total cost exceeds
# the plain version's by at most ELLIPTIC_COST_RTOL of max(|cost|, 1) on
# every env (an env whose constraints are all off costs ~0). At the
# model's settings the batch's mean cost must stay within
# ELLIPTIC_MEAN_COST_RTOL of the plain version's. The kernel's max_abs_err
# is taken where the bars are elementwise.
ELLIPTIC_ENV_TOL = 1e-4
ELLIPTIC_CONVERGED_TOL = 1e-2
ELLIPTIC_COST_RTOL = 1e-5
ELLIPTIC_MEAN_COST_RTOL = 1e-2
# card (kernels) vs CPU (plain versions) after 20 steps: f32 reduction order
# plus discrete take/keep decisions inside the Newton solve
QPOS_TOL, QVEL_TOL = 1e-3, 1e-2
# The elliptic quadruped at its own 3 x 6 solver iterations is chaotic in
# those decisions: the JAX package's rollout moves by 1.2e-2 in qpos and
# 0.23 in qvel after 20 steps when its start moves by 1e-6. Its card-vs-CPU
# bars at those settings are therefore loose; the strict bars above hold
# with the solver converged (15 x 15).
ELLIPTIC_QPOS_TOL, ELLIPTIC_QVEL_TOL = 5e-2, 1.0
CONVERGED = dict(iterations=15, ls_iterations=15)
# Kernel 4's synthetic problems at one lane per dof, from one to a full
# warp. synthetic_structured_problem's own problem activates 80% of the rows
# with D in [1, 10]: J^T f then sums ~30 terms of ~10 that cancel, and at
# 4096 envs plain float32 misses its own float64 run at 1e-4 on more envs
# than NEWTON_MIN_SHARE leaves, so no float32 summation order could meet
# that bar against it. There the kernel is held against float64: its share
# of envs within NEWTON_TOL of float64 may fall short of plain float32's by
# at most NEWTON_F64_SLACK. Plain float32 with kernel 4's own algebra for
# the contacts (products with the basis, the pyramid forces folded, the
# rank-3 Hessian) falls short of plain's share by up to 0.93 points, and
# reordering plain's own sums moves it by up to 0.87 points below
# (tools/newton_share.py on the CPU: 4096 envs, NEWTON_NVS, seeds 3 + nv and
# 80 + nv); the slack holds both. Kernel 5's own problems
# (synthetic_dense_problem's, seeds 80 + nv and 130 + nv): its order (rank-1
# Hessian updates and J^T f row by row, warp sums) run as plain float32
# falls short by up to 0.39 points, reordering by up to 0.32
# (tools/newton_share.py --kernel 5 on the card). SYNTHETIC_EASED activates
# 15% (the quadruped's pre-solve has 22 of 136 rows, 16%) with D in
# [0.1, 1], where plain float32 meets float64 on 99.7-100% of envs, and
# kernels 4 and 5 are held against plain float32 at the NEWTON_* bars.
NEWTON_NVS = (1, 7, 18, 25, 32)
NEWTON_F64_SLACK = 0.02
SYNTHETIC_EASED = dict(active=0.15, d_range=(0.1, 1.0))
# Kernel 6's sweep at NEWTON_NVS x cdim 2-6 (4096 envs; one line-search step
# within ELLIPTIC_ENV_TOL, converged within ELLIPTIC_CONVERGED_TOL by
# env_rel_err) is held against float64 in the same way. There its own
# order (the rank-cdim contact updates, row-by-row sums, warp sums) run as
# plain float32 falls short of plain's share by up to 2.08 points (nv = 1,
# cdim 5, one step), reordering plain's sums by up to 0.73 (nv = 32)
# (tools/newton_share.py --kernel 6 on the card): ELLIPTIC_F64_SLACK. A
# converged cost can end far above float64's in any float32 order: a line
# search that fails to lower the cost ends the solve, and whether it fails
# can turn on an ulp of the bracket (tools/elliptic_trace.py). Reordered
# or in kernel 6's order, plain float32 ends above the larger of plain
# float32's and float64's cost by more than ELLIPTIC_COST_RTOL of
# max(|cost|, 1) on up to 3 envs of 4096 (by up to 0.69 of it), so the
# kernel may on at most ELLIPTIC_COST_ENVS.
ELLIPTIC_F64_SLACK = 0.03
ELLIPTIC_COST_ENVS = 4

# PPO on the 4096-env quadruped (bench.py:142-177's settings): one training
# step, 8 unrolls x 5 control steps x 4 physics steps = 160 physics steps.
# Cut: episode_length 25 instead of 500 (100 until section 9 came), so that
# the two evals stay short and the 40-step unroll crosses truncations, and
# unroll_length 5 instead of 20 (20 until the sensor phases came, 10 until
# the weld phases came; num_timesteps follows, one training step).
PPO_QUADRUPED = dict(
    num_timesteps=163_840, num_evals=2, episode_length=25, normalize_observations=True, unroll_length=5,
    num_minibatches=32, num_updates_per_batch=4, discounting=0.97, learning_rate=3e-4, entropy_cost=1e-2,
    num_envs=4096, num_eval_envs=64, batch_size=1024, seed=0,
)
# PPO on the pendulum swingup (examples/rl/pendulum/ex_agents.py:30-45 and
# its env, 2 physics steps per control step): 12 training steps, 5 evals.
PPO_PENDULUM = dict(
    num_timesteps=500_000, num_evals=5, episode_length=200, normalize_observations=True, unroll_length=10,
    num_minibatches=8, num_updates_per_batch=4, discounting=0.97, learning_rate=3e-4, entropy_cost=1e-3,
    num_envs=512, batch_size=640, reward_scaling=0.1, seed=0,
)
# PPO on humanoid_balance (benchmarks/ladder.py:194-219's settings): one
# training step, 1 unroll x 10 control steps x 5 physics steps = 50
# physics steps. Cut: episode_length 25 instead of 300 (100 until section 9
# came), one training step and unroll_length 10 instead of 20 (until the
# sensor phases came), as the quadruped's is cut.
PPO_HUMANOID = dict(
    num_timesteps=10_240, num_evals=2, episode_length=25, normalize_observations=True, unroll_length=10,
    num_minibatches=16, num_updates_per_batch=4, discounting=0.97, learning_rate=3e-4, entropy_cost=1e-2,
    num_envs=1024, num_eval_envs=64, batch_size=64, seed=0,
)
# quadruped_terrain (ambersim_tpu_torch/rl/quadruped/terrain.py) at
# examples/rl/quadruped/ex_terrain.py:26's config: the quadruped over a
# 24 x 24 height field generated from terrain_seed 3 (17 height-field
# pairs, ncon 68, nefc 296), a forward command of 0.4 m/s.
TERRAIN_CONFIG = dict(terrain_seed=3, target_vel=0.4)
# The generator flattens the field to ~1-3 mm about the spawn (xy = 0), so
# the terrain path, its card-vs-CPU rollout and env, and kernel 4's
# terrain operands start each env at a seeded xy within TERRAIN_SPREAD m of
# it, over the relief (onto_terrain).
TERRAIN_SPREAD = 5.0
# PPO on it at ex_terrain.py:26-44's settings, which are PPO_QUADRUPED's
# but for the cuts: one training step, episode_length 25 instead of 500
# and 2 evals of 64 envs instead of 10 of 512, as PPO_QUADRUPED is cut.
PPO_TERRAIN = dict(PPO_QUADRUPED)
# ray() card against CPU: tests/test_ray.py:40-62's rig of every geom type
# (its rangefinders left out: the port computes no sensors yet) with
# tests/test_ray.py:65-90's convex octahedron mesh beside them (ray_hull),
# RAY_ENVS envs each at its own pose casting one ray; and the terrain scene,
# NUM_ENVS quadrupeds spread over the field each casting TERRAIN_RAYS
# downward rays about its trunk. Distances within RAY_TOL (the JAX
# package's bar against mj_ray, tests/test_ray.py), the same geom ids.
RAY_RIG = """
<mujoco>
  <option timestep="0.002"/>
  <asset><mesh name="octa" file="octa.obj"/></asset>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body pos="0 0 1">
      <joint name="jy" axis="0 1 0" damping="0.1"/>
      <geom name="host" type="box" size="0.1 0.1 0.1"/>
    </body>
    <body pos="1.2 0 1"><joint axis="0 1 0"/><geom name="ball" type="sphere" size="0.15"/></body>
    <body pos="0 1.2 1"><joint axis="1 0 0"/><geom name="cap" type="capsule" size="0.08 0.2" euler="90 0 0"/></body>
    <body pos="-1.2 0 1"><joint axis="0 1 0"/><geom name="cyl" type="cylinder" size="0.12 0.15"/></body>
    <body pos="0 -1.2 1"><joint axis="1 0 0"/><geom name="ell" type="ellipsoid" size="0.1 0.15 0.2"/></body>
    <body pos="1.2 1.2 1"><joint axis="0 1 0"/><geom name="bx" type="box" size="0.1 0.12 0.14" euler="10 20 30"/></body>
    <body pos="-1.2 1.2 1"><joint axis="0 1 0"/><geom name="m" type="mesh" mesh="octa"/></body>
  </worldbody>
</mujoco>
"""
OCTA_OBJ = """
v 0.2 0 0
v -0.2 0 0
v 0 0.25 0
v 0 -0.25 0
v 0 0 0.3
v 0 0 -0.3
f 1 3 5
f 3 2 5
f 2 4 5
f 4 1 5
f 3 1 6
f 2 3 6
f 4 2 6
f 1 4 6
"""
RAY_ENVS = 4096
# after one untimed pass of a case's casts on the card (the one compared),
# its rays/s are timed over RAY_REPS more
RAY_REPS = 5
TERRAIN_RAYS = 9
RAY_TOL = 1e-4
# BASELINE.md:13's predictive-sampling workload on the Barrett-class hand
# (models/hand/hand.xml): 100 samples x 10 knots, Newton with 1 iteration
# and 4 line-search iterations, the model's dt 0.002 and Euler, contacts
# disabled; the cost of the JAX package's
# tests/trajopt/test_predictive_sampler.py:36-41 and its stdev 0.3.
HAND_SAMPLES, HAND_HORIZON, HAND_STDEV = 100, 10, 0.3
# The mesh hand (models/hand/hand_mesh.xml, compiled on the card by the
# port) at BASELINE.md:13's width, HAND_SAMPLES samples x HAND_HORIZON
# knots, Newton 1 x 4 with contacts enabled, as
# tests/test_models_parity.py:199-221 runs it (its cost: goal f1_prox 1
# rad, stdev 0.2, from rest and the zero guess). Its meshes collide only
# with objects and the file holds none, so it has no contact pair: the
# phase runs the mesh compile and the mimic rows. Without contact slots its
# rows have no pyramid structure, so its Newton solve is kernel 5
# (newton_dense), not the hand's kernel 4.
MESH_HAND_XML = "models/hand/hand_mesh.xml"
MESH_HAND_STDEV = 0.2
HAND_TRAJOPT = dict(iterations=1, ls_iterations=4)
# cut: 20 until the sensor phases came, 10 until the tendon phases came, 5 until the weld phases came
HAND_OPTIMIZE_CALLS = 3
# MPC on the same hand: 10 control steps of one problem, and of a batch of
# 8 (a solve is then 800 envs); cut: 20 until the sensor phases came. Its cost weighs the goal's joint angles at
# 10, as tests/trajopt/test_mpc.py weighs the pendulum's, and the joint
# velocities at 1e-3: at the sampler's weights (0.1, terminal 10) the
# 10-knot (0.02 s) horizon cannot turn a finger without paying more for
# its speed than it gains in angle, and the loop keeps the guess.
HAND_MPC_STEPS, HAND_MPC_BATCH, HAND_MPC_STDEV = 10, 8, 0.5
# The hand at its own options (contacts on, 4 x 8 iterations): 1024 envs x
# 100 steps from starts spread over the joints' ranges (hand_start) under a
# closing ctrl (spread 1, each proximal joint 2, the top of its range), so
# the fingers meet the palm and each other.
HAND_CONTACT_ENVS, HAND_CONTACT_STEPS = 1024, 100
HAND_CLOSING_CTRL = (1.0, 2.0, 2.0, 2.0)
# What the JAX package's trainer gains at PPO_PENDULUM (final minus untrained
# eval reward), run on a CPU with seeds 0, 1 and 2: the port must gain at
# least half their mean.
JAX_PENDULUM_GAINS = (482.879, 217.651, 227.194)

# Gradients through the kernels (each kernel's Function: the kernel forward,
# autograd through its plain version backward) against the plain version's
# gradient on the CPU from the same inputs. Per input, an env is within when
# its largest |card - CPU| is at most GRAD_TOL of the largest |CPU gradient|
# of that input: every env for kernels 1-3 and the paths, GRAD_MIN_SHARE of
# the envs for the Newton routes (as their forward bars, NEWTON_MIN_SHARE),
# whose gradients follow active rows and line-search steps that the two
# devices' sums can tip apart; where plain float32 itself meets float64 on
# fewer, vs_float64's rule (grad_kernels). The CPU gradient is taken on the
# first GRAD_CPU_ENVS envs of a Newton row and GRAD_CPU_SYSTEMS systems of
# kernels 1-3 (each env's gradient reads its own inputs alone); the card's
# on the JSON row's whole batch.
GRAD_TOL = 1e-3
GRAD_MIN_SHARE = 0.99
GRAD_CPU_ENVS, GRAD_CPU_SYSTEMS = 512, 64
# The unrolled Newton solves' float32 gradients with respect to qM and the
# warmstart (and, converged, the elliptic solve's with respect to every
# input) meet float64 within GRAD_TOL on only 47-94% of envs on the CPU
# (line-search steps whose derivatives cancel large terms); there the card's
# share may fall short of plain float32's by GRAD_F64_SLACK. The card and
# plain float32 parted by at most 0.016 of 512 envs (an H100 80GB HBM3, 700 W).
GRAD_F64_SLACK = 0.05
# The elliptic quadruped's path gradient, converged: every env within this
# share of the largest |g| (converged elliptic solves still end where float32
# rounding moves them, as the forward's ELLIPTIC_* bars say: one of 16 envs
# parted by 3.5e-2, the first 8 by 1.1e-4, on an H100 80GB HBM3 at 700 W)
GRAD_ELLIPTIC_PATH_TOL = 1e-1
# d(sum qpos + sum qvel after T steps)/d(ctrl tape, initial qvel), card vs
# CPU: path -> (model, envs, steps, solver options); the elliptic
# quadruped converged, as its forward is compared (CONVERGED); the hand at
# the trajectory-optimization workload's options (hand_model: Newton 1 x 4,
# contacts off), where its gradient optimizers run (with contacts on an
# env's gradient parted by 2.7e-2 of the largest |g| on an H100 80GB HBM3).
# Cut: half the steps (20 / 10 until the sensor phases came), the elliptic
# quadruped's 2 (5 until the weld phases came, 3 until the condim and
# integrator phases came), the pendulum's and arm3's 5 (10 until then).
# The quadruped with noslip (its path's model, a build function of the
# device) runs converged, as its path is held card vs CPU, 16 envs x 3
# steps: noslip's M^-1 J^T is kernel 2's Function at k = 136 forward, its
# plain version backward (tests/test_torch_noslip.py holds the pass's
# reverse mode against its forward mode). The quadruped under CG runs its own 3
# iterations with 2 line-search steps, not 15 x 15: there the converged
# solve's unrolled gradient is not defined by its inputs in either package,
# even in float64 (tools/grad_spread.py, the same model, start and tape in
# both: a 1e-9 nudge of qvel0 moves the JAX package's float64 gradient by
# 0.17 of the largest |g| over one step of 4 envs and 0.78 over these 16 x
# 3, the port's by 0.12 and 0.75). At 3 x 2 the port's float64 gradient
# moves by 2.1e-7 under that nudge and its float32 one is 1.6e-4 from it and
# 3.7e-4 from the JAX package's float32 over 16 x 3; over one step of 4
# envs the two packages' float64 gradients meet within 1.6e-15 at 3 x 2 and
# 1 x 4 (tests/test_torch_cg.py holds the float32 ones within 1e-4 there).
GRAD_PATHS = {
    "pendulum": ("pendulum", 16, 5, None), "arm3": ("arm3", 16, 5, None), "quadruped": ("quadruped", 64, 5, None),
    "quadruped_elliptic": ("quadruped_elliptic", 8, 2, CONVERGED), "hand": ("hand", 16, 5, None),
    "clutter32_rowcap192": ("clutter32_rowcap192", 4, 2, None),
    "quadruped_cg": (lambda device: cg_quadruped(device), 16, 3, dict(iterations=3, ls_iterations=2)),
    "quadruped_noslip": (lambda device: xml_model(noslip_quadruped_xml(), device), 16, 3, CONVERGED),
}
# APG on the pendulum swingup (examples/rl/pendulum/ex_agents.py:80-87 and
# its env, 2 physics steps per control step). Cut: 1 policy update and 2
# evals instead of 60 and 5 (4 updates until section 9 came, 2 until the
# terrain phases came), episodes of 50 control steps instead of 200
# (until the sensor phases came). The first
# update's loss and grad norm, card against CPU from the same params and
# starts, within APG_FIRST_RTOL; that repeated update is cut to
# APG_FIRST_EPISODE control steps (50 until section 9 came).
APG_PENDULUM = dict(episode_length=50, num_envs=64, policy_updates=1, learning_rate=2e-3, max_gradient_norm=1.0,
                    num_evals=2, seed=0)
APG_FIRST_RTOL = 1e-3
APG_FIRST_EPISODE = 20
# APG on quadruped_locomotion at bench.py's 4096 envs. Cut: episode_length
# 5 control steps (20 physics steps; 20 until section 9 came, 10 until the
# sensor phases came) and one update.
APG_QUADRUPED = dict(episode_length=5, num_envs=4096, num_eval_envs=64, policy_updates=1, learning_rate=1e-3,
                     max_gradient_norm=1.0, num_evals=1, seed=0)
# ES on the pendulum swingup (examples/rl/pendulum/ex_agents.py:60-67 and
# its env, 2 physics steps per control step): population 256, std 0.08,
# lr 0.02. Cut: 1 policy update and 1 eval instead of 120 and 5 (4
# updates until the terrain phases came, 2 until the sensor phases came; 2
# evals until the weld phases came), episodes of 50 control steps instead
# of 200 (200 until the sensor phases came, 100 until the weld phases came:
# the first update's card-vs-CPU check reads POPULATION_FIRST_EPISODE, 50).
ES_PENDULUM = dict(episode_length=50, population_size=256, perturbation_std=0.08, learning_rate=0.02,
                   policy_updates=1, num_evals=1, seed=0)
# ARS on the pendulum (ex_agents.py:69-78): 64 directions, top 16, step
# 0.015, noise 0.04, normalized obs. Cut as ES_PENDULUM.
ARS_PENDULUM = dict(episode_length=50, number_of_directions=64, top_directions=16, step_size=0.015,
                    exploration_noise_std=0.04, normalize_observations=True, policy_updates=1, num_evals=1, seed=0)
# SAC on the pendulum (ex_agents.py:45-58): 64 envs, batch 256, replay
# 2,048-262,144, 4 gradient updates a step, discount 0.97, lr 6e-4, reward
# scaling 0.1, normalized obs. Cut: num_timesteps 4,096 instead of 120,000
# (the 32-step prefill, then 32 training steps; 256 until the terrain
# phases came, 128 until the sensor phases came) and 1 eval instead of 5 (2
# until the weld phases came).
SAC_PENDULUM = dict(num_timesteps=4_096, num_evals=1, episode_length=200, normalize_observations=True, num_envs=64,
                    batch_size=256, min_replay_size=2_048, max_replay_size=262_144, grad_updates_per_step=4,
                    discounting=0.97, learning_rate=6e-4, reward_scaling=0.1, seed=0)
# ES on quadruped_locomotion (nv 18, obs 45, 12 actions, 4 physics steps a
# control step) at population 512, the trainer's defaults otherwise: each
# of 512 envs acts with its own params. Cut: episode_length 25 (50 until
# the sensor phases came), one update and one eval of 64 envs.
ES_QUADRUPED = dict(episode_length=25, population_size=512, policy_updates=1, num_evals=1, num_eval_envs=64, seed=0)
# SAC on quadruped_locomotion at the trainer's defaults (128 envs, batch
# 256, (256, 256) critics and policy, a replay of 1,000,000 transitions on
# the card). Cut: min replay 1,024 (8 prefill actor steps), episode_length
# 25 (ES_QUADRUPED's; 50 until the fluid and per-env-leaf phases came), 25
# training steps (100 and 50 until the sensor phases came) and one eval of
# 64 envs.
SAC_QUADRUPED = dict(num_timesteps=1_024 + 25 * 128, num_evals=1, episode_length=25, min_replay_size=1_024,
                     num_eval_envs=64, seed=0)
# Card against CPU. ES and ARS: the first update's population returns
# over POPULATION_FIRST_EPISODE control steps from the same params, starts
# and noise, their mean within APG_FIRST_RTOL; then the update from the
# CPU's returns on both devices within POPULATION_UPDATE_RTOL of each
# leaf's largest |param|. SAC: SAC_FIRST_SGD SGD steps from the same
# buffer, indices and normals, the losses within SAC_LOSS_RTOL, the params
# within rtol 1e-4 and atol 1e-3 x the learning rate. Where a param parts
# by more, the card is held to the same steps in float64 on the CPU: in
# no leaf farther from it than the CPU's float32 farthest, plus that atol.
# (Adam divides each gradient component by its running scale, so a
# component that float32 sums to near 0 moves by a good part of the
# learning rate on either device, however its sums are ordered.)
POPULATION_FIRST_EPISODE = 50
POPULATION_UPDATE_RTOL = 1e-5
SAC_FIRST_SGD = 4
SAC_LOSS_RTOL = 1e-3
# examples/trajopt/ex_ilqr.py task 1: the pendulum asset, 50 knots, 12
# iterations, goal angle 0.7. The JAX package reaches 0.6759496 on a CPU
# (the example's task run as written); the port's final angle may be at
# most ILQR_ANGLE_SLACK farther from the goal than that.
ILQR_PENDULUM = dict(knots=50, iterations=12, goal=0.7)
JAX_ILQR_PENDULUM_ANGLE = 0.6759496
ILQR_ANGLE_SLACK = 1e-3
# ILQR_PENDULUM over tests/trajopt/test_ilqr.py:130-150's four initial
# angles, spread over [-1, 1] rad at rest, as one batch of problems; each
# problem held against the card's own single-problem solve from the same
# start within ILQR_BATCH_TOLS (xs, us): the same arithmetic on another
# batch shape (the CPU gives the bits)
ILQR_BATCH_STARTS = (-1.0, -1.0 / 3.0, 1.0 / 3.0, 1.0)
ILQR_BATCH_TOLS = (1e-4, 1e-3)
# The hand at BASELINE.md:13's 10 knots (hand_sampling's cost, start and
# guess): Adam through the step, and iLQR. Cut: 8 Adam iterations (30
# until section 9 came, 15 until the sensor phases came).
HAND_GRADIENT_ITERS, HAND_ILQR_ITERS = 8, 5

# Model I/O on the card: the port's own compiler (ambersim_tpu_torch.mjcf)
# on this machine. tools/export_model_npz.py:37-53's table, copied (this
# script imports nothing of tools/): asset -> (MJCF file, the loader's cone
# override, broadphase cap, max_contact_points row cap). compile_models
# compiles each and holds it against the committed assets/<name>.npz, which
# the JAX package compiled on another machine.
COMPILED_ASSETS = {
    "quadruped": ("models/quadruped/quadruped.xml", None, 0, 0),
    "quadruped_elliptic": ("models/quadruped/quadruped.xml", "elliptic", 0, 0),
    "cartpole": ("models/cartpole/cartpole.xml", None, 0, 0),
    "arm3": ("models/arm3/arm3.xml", None, 0, 0),
    "humanoid": ("models/humanoid/humanoid.xml", None, 0, 0),
    "pendulum": ("models/pendulum/pendulum.xml", None, 0, 0),
    "hand": ("models/hand/hand.xml", None, 0, 0),
    "clutter32_cap48": ("models/objects/clutter32.xml", None, 48, 0),
    "clutter32_rowcap192": ("models/objects/clutter32.xml", None, 48, 192),
    "drop_scene": ("models/objects/drop_scene.xml", None, 0, 0),
    "rock": ("models/rock/rock_scene.xml", None, 0, 0),
    "clutter32": ("models/objects/clutter32.xml", None, 0, 0),
}
# compile_models' bars: integer, bool and structural fields exact; float
# leaves within COMPILE_RTOL / COMPILE_ATOL (numpy's eigh at the meshes'
# principal frames and the inertias' may round otherwise on another
# LAPACK); the three setconst fields within cond(qM at qpos0) x float32's
# unit roundoff, floored at 1e-6 (the port's float32 smooth pass against the
# JAX package's XLA one: tests/test_torch_mjcf.py). Mesh fields are held up
# to the hull's vertex, face and edge order if qhull orders them otherwise.
COMPILE_RTOL, COMPILE_ATOL = 1e-5, 1e-6
UNIT_ROUNDOFF_F32 = 2.0**-24
SETCONST_FIELDS = ("dof_invweight0", "body_invweight0", "actuator_acc0")
MESH_FIELDS = ("mesh_vert", "mesh_face_normal", "mesh_face_dist", "mesh_face_vert", "mesh_edge", "mesh_face_nvert")
# tests/test_model_io.py:20-50's gripper URDF, copied: one revolute joint
# mimics the other (q2 = 0.1 + 0.5 q1, a joint equality row) and one
# transmission makes a motor. gripper_urdf loads it with force_float and
# steps GRIPPER_ENVS x GRIPPER_STEPS under a closing ctrl, each env's drawn
# from U(0.25, 0.75) by numpy seed 21 (the effort limit is 1.5); the mimic
# row holds to MIMIC_TOL in every env at the end. Card vs CPU on 8 envs x
# GRIPPER_CPU_STEPS: the plain Newton solve runs all of the model's default
# 100 x 50 iterations, ~1.5 s a step on a CPU.
GRIPPER_URDF = """<?xml version="1.0"?>
<robot name="gripper">
  <link name="palm">
    <inertial><mass value="0.5"/><origin xyz="0 0 0"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.001"/></inertial>
    <collision><geometry><box size="0.08 0.04 0.02"/></geometry></collision>
  </link>
  <link name="finger1">
    <inertial><mass value="0.1"/><origin xyz="0 0 0.02"/>
      <inertia ixx="0.0001" ixy="0" ixz="0" iyy="0.0001" iyz="0" izz="0.0001"/></inertial>
    <collision><geometry><capsule radius="0.008" length="0.04"/></geometry></collision>
  </link>
  <link name="finger2">
    <inertial><mass value="0.1"/><origin xyz="0 0 0.02"/>
      <inertia ixx="0.0001" ixy="0" ixz="0" iyy="0.0001" iyz="0" izz="0.0001"/></inertial>
    <collision><geometry><capsule radius="0.008" length="0.04"/></geometry></collision>
  </link>
  <joint name="finger1_joint" type="revolute">
    <parent link="palm"/><child link="finger1"/>
    <origin xyz="0.04 0 0.01"/><axis xyz="0 1 0"/>
    <limit effort="1.5" lower="0" upper="1.2"/>
  </joint>
  <joint name="finger2_joint" type="revolute">
    <parent link="palm"/><child link="finger2"/>
    <origin xyz="-0.04 0 0.01"/><axis xyz="0 -1 0"/>
    <limit effort="1.5" lower="0" upper="1.2"/>
    <mimic joint="finger1_joint" multiplier="0.5" offset="0.1"/>
  </joint>
  <transmission name="t1"><type>x</type><joint name="finger1_joint"/>
    <actuator name="finger1_act"/></transmission>
</robot>
"""
GRIPPER_ENVS, GRIPPER_STEPS, GRIPPER_CPU_STEPS = 1024, 100, 5
MIMIC_TOL = 5e-3
# models/hand/grasp_scene.xml (the mesh hand's seven convex-decomposed parts
# closing on a free mesh object: 12 mesh-mesh pairs a step, 4 mimic rows) at
# tests/test_models_parity.py:171-196's settings, GRASP_STEPS steps of
# GRASP_CTRL. Batch: the largest of GRASP_BATCHES whose collision stage
# (mesh_mesh's SAT inside), at the per-env peak measured on GRASP_PROBE_ENVS
# envs, stays under GRASP_PEAK_GIB (grasp_memory). Every env's object moved
# by GRASP_NUDGE N(0, 1) per axis (numpy seed 22). Gates: the object held in
# the palm channel (GRASP_Z on its height) in every env, and on 8 envs over
# GRASP_CPU_STEPS steps the card against the CPU by the spread method
# (settled_card_vs_cpu's bars: the contact is sustained from step ~60) and
# the f1 mimic ratio within MIMIC_TOL. Cut: the CPU's 8 envs take ~0.12 s a
# step, so they run GRASP_CPU_STEPS of the 300 (150 until the sensor phases
# came). The 300 stay: kernel 4 is held on the final state
# (check_newton_ladder).
GRASP_XML = "models/hand/grasp_scene.xml"
GRASP_CTRL = (0.0, 1.2, 1.2, 1.2)
GRASP_STEPS = 300
GRASP_CPU_STEPS = 100
GRASP_BATCHES = (1024, 256, 64)
GRASP_PEAK_GIB = 20.0
GRASP_PROBE_ENVS = 16
GRASP_NUDGE = 1e-3
GRASP_Z = (0.08, 0.15)
# conditioned_within's factor on cond(qM) x u: plain float32's qacc on the
# gripper's operands (cond 7.9e3) reached 1.01 of that first-order bound on
# 64 envs on a CPU; check_newton_ladder prints the factor plain float32 and
# the kernel reach on the card (conditioned_factor)
CONDITIONED_QACC = 2.0

# kernels whose ptxas report must show no spill: kernels 1-3 at n <= 32,
# which hold a row of A or L in registers (kernels 2 and 3 in one
# instantiation per copy), and the Newton kernels 4-6, whose factor holds
# the Hessian's rows in registers (kernels 5 and 6 in one instantiation per
# register tier).
SPILL_FREE = ("cholesky_kernel", "cho_solve_kernel", "solve_pd_kernel", "newton_structured_kernel",
              "newton_dense_kernel", "newton_elliptic_kernel")
# kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "cholesky": ("linalg.cu", "ambersim_tpu/ops/linalg_pallas.py:319"),
    "cho_solve": ("linalg.cu", "ambersim_tpu/ops/linalg_pallas.py:324"),
    "solve_pd": ("linalg.cu", "ambersim_tpu/ops/linalg_pallas.py:314"),
    "cholesky_block": ("linalg_block.cu", "ambersim_tpu/ops/linalg_pallas.py:319"),
    "cho_solve_block": ("linalg_block.cu", "ambersim_tpu/ops/linalg_pallas.py:324"),
    "solve_pd_block": ("linalg_block.cu", "ambersim_tpu/ops/linalg_pallas.py:314"),
    "newton_structured": ("newton_structured.cu", "ambersim_tpu/ops/newton_pallas.py:582"),
    "newton_dense": ("newton_dense.cu", "ambersim_tpu/ops/newton_pallas.py:247"),
    "newton_elliptic": ("newton_elliptic.cu", "ambersim_tpu/ops/newton_pallas.py:1083"),
}

# Sensors and servos. quadruped_sensors: the main path's quadruped with an
# IMU site, a sphere site at each foot and 52 sensors (81 sensordata
# columns), its 12 motors made position servos whose kp, kv and forcerange
# are pd_ctrl's gains and the motors' +-28 (quadruped_sensors_xml), at
# NUM_ENVS x NUM_STEPS from initial_batch with ctrl at zero.
QUADRUPED_XML = "ambersim_tpu/models/quadruped/quadruped.xml"
FEET = ("FL", "FR", "RL", "RR")
# the same-input check: sensors() on the card and on the CPU from one Data,
# position and velocity rows within SENSOR_TOL, acceleration and force rows
# within SENSOR_FORCE_TOL (rtol, atol)
SENSOR_TOL, SENSOR_FORCE_TOL = (1e-5, 1e-6), (1e-4, 1e-4)
# efc_aref's bar from the same Data (tests/test_torch_constraint.py's: four
# float32 ulps of a contact distance times k * imp)
AREF_ATOL = 3e-4
# a geom-distance normal's rounding: four float32 ulps of a world
# coordinate near 1 m, over the distance dd between the points it joins
# (normal_atol; tests/test_torch_sensor_contacts.py holds the port to the
# JAX package at the same bar)
NORMAL_ULPS = 4 * 1.2e-7
# The sensor rigs' rollouts, card against CPU: SENSOR_RIG_STEPS steps at
# CONVERGED solver options (below), not the rigs' default 100 x 50
# iterations, which the CPU's plain Newton arrays take ~1.4 s a step at
SENSOR_RIG_STEPS = 10
# Tendons and muscles. muscle_arm: examples/ex_muscle_tendon.py's ARM
# (:27-61; a spatial tendon over a cylinder, FLV muscles on it and on the
# shoulder), read from the file as text and compiled here, at NUM_ENVS x
# ARM_STEPS from qpos0 + 0.05 N(0, 1) (arm_start) under the example's
# excitation (:71-72): biceps ARM_BICEPS[0] on steps ARM_EXCITE, ARM_BICEPS[1]
# otherwise, shoulder ARM_SHOULDER. Its rows (two joint limits, the
# tendon's limit; no contacts) go to kernel 5.
ARM_STEPS, ARM_EXCITE, ARM_BICEPS, ARM_SHOULDER = 300, (50, 200), (0.8, 0.05), 0.3
# muscle_arm_sampling, the example's predictive sampling (:88-102): Q 0.1 I,
# Qf 10 I, R 0.01 I, goal ARM_GOAL, 64 samples of stdev 0.3 around a
# 100-knot guess of 0.3 from x0 = 0; ARM_OPTIMIZE_CALLS calls (cut: 5 until
# the weld phases came, 3 until the condim and integrator phases came)
ARM_SAMPLES, ARM_KNOTS, ARM_STDEV, ARM_GUESS, ARM_OPTIMIZE_CALLS = 64, 100, 0.3, 0.3, 2
ARM_GOAL = (0.0, -1.2, 0.0, 0.0)
# tendon_rig: tests/test_tendon_parity.py's TENDON_RIG (:24-63: a tendon
# equality, friction and limit row and a condim-3 contact, through kernel 4
# with nd_eq = nd_ft = 1) at NUM_ENVS x TENDON_RIG_STEPS from 0.05 N(0, 1)
# under the test's rollout ctrl (:146)
TENDON_RIG_STEPS = 100
# tendon_rigs, card against CPU as the sensor rigs (SENSOR_RIG_STEPS steps
# at CONVERGED options, then one forward from the same Data): the JAX
# package's tendon and muscle fixtures, TENDON_RIG with a tendonactuatorfrc
# sensor, each from tendon_rig_start
TENDON_RIGS = {
    "spatial_rig": lambda: tests_xml("test_spatial_tendon.py", "SPATIAL_RIG"),
    "pulley_ring": lambda: tests_xml("test_spatial_tendon.py", "PULLEY_RING"),
    "tendon_limit_sensor_rig": lambda: tests_xml("test_tendon_parity.py", "TENDON_LIMIT_SENSOR_RIG"),
    "muscle_rig": lambda: tests_xml("test_muscle.py", "MUSCLE_RIG"),
    "tendon_rig_actfrc": lambda: tests_xml("test_tendon_parity.py", "TENDON_RIG").replace(
        '<tendonvel name="tv" tendon="couple"/>',
        '<tendonvel name="tv" tendon="couple"/>\n    <tendonactuatorfrc name="taf" tendon="flex"/>'),
}
# Welds, transmissions and pairs. mocap_weld: tests/test_mocap.py's MOCAP_WELD
# (:16-27, a free box welded to a mocap target: six equality rows, no
# contacts, through kernel 5) at NUM_ENVS x WELD_STEPS from qpos0, each env's
# target WELD_TARGET + WELD_SPREAD N(0, I) (seeded_noise 23); every box within
# WELD_BAR of its target at the last step. mocap_drag: the same with a floor
# plane at z = DRAG_FLOOR under the box, which starts resting on it (six
# equality rows and four condim-3 contacts, through kernel 4 with nd_eq 6),
# each env's target (WELD_TARGET[:2] + WELD_SPREAD N(0, I), DRAG_Z)
# (seeded_noise 24); every box within DRAG_BAR of its target, no geom
# DRAG_FLOOR_TOL under the floor and contact rows active on some envs at the
# last step. The weld drags each box's leading edge into the soft contact:
# the JAX package's own run of this start sinks a corner 9.55 mm on 4096
# envs (8.00 mm on the first 256; tools/weld_reference.py) and the port's
# 8.33 mm on the H100, so the drag's floor bar is 12 mm, 1.26 x the JAX
# package's reading, not the settled scenes' FLOOR_TOL (5 mm).
# refsite_arm: tests/test_refsite.py's ARM_XML (:23-46, three refsite
# position servos toward a world site; damped joints, a contact row) at
# NUM_ENVS x REFSITE_STEPS from qpos 0.1 N(0, 1) (seeded_noise 25), ctrl 0;
# each actuator's largest |actuator_length| at the last step below
# REFSITE_SHRINK of that at the start
WELD_STEPS, REFSITE_STEPS = 100, 300
WELD_TARGET, WELD_SPREAD, DRAG_FLOOR, DRAG_Z = (0.25, 0.1, 0.6), 0.05, 0.45, 0.5
WELD_BAR, DRAG_BAR, DRAG_FLOOR_TOL, REFSITE_SHRINK = 0.01, 0.05, 0.012, 1.0 / 3.0
# weld_rigs, card against CPU as the tendon rigs (SENSOR_RIG_STEPS steps at
# CONVERGED options from rig_start, then one forward from the same Data:
# actuator lengths, velocities and moments, efc rows): the JAX package's
# weld, ball-limit, transmission and pair fixtures (tests/test_torch_weld.py,
# test_torch_transmissions.py, test_torch_pairs.py hold them on the CPU)
WELD_RIGS = {
    "connect_swing": lambda: tests_xml("test_constraint_parity.py", "CONNECT_SWING"),
    "weld_pair": lambda: tests_xml("test_constraint_parity.py", "WELD_PAIR"),
    "ball_limited": lambda: tests_xml("test_constraint_parity.py", "BALL_LIMITED"),
    "hand_weld": lambda: (REPO / "ambersim_tpu" / "models" / "hand" / "hand.xml").read_text().replace(
        "</equality>", '<weld body1="f1_dist_link" body2="f2_dist_link"/></equality>'),
    "trn_extra": lambda: tests_xml("test_trn_extra.py", "XML"),
    "thruster_rig": lambda: tests_xml("test_muscle.py", "THRUSTER_RIG"),
    "adhesion_box": lambda: tests_xml("test_adhesion.py", "BOX_XML"),
    "adhesion_gap": lambda: tests_xml("test_adhesion.py", "GAP_XML"),
    "ball_body": lambda: tests_xml("test_ilqr.py", "BALL_BODY", folder="tests/trajopt"),
    "explicit_pair": lambda: tests_xml("test_torch_bridge.py", "EXPLICIT_PAIR_XML"),
    "override_on": lambda: tests_xml("test_flags.py", "OVERRIDE_SCENE").format(flag='override="enable"'),
    "override_off": lambda: tests_xml("test_flags.py", "OVERRIDE_SCENE").format(flag='energy="enable"'),
}
# ilqr_ball: tests/trajopt/test_ilqr.py:test_ilqr_ball_joint_manifold (the
# box on a ball joint, three motors; 0.01 |u|^2 a knot, 200 |x_N - goal|^2 on
# the tangent state, goal 0.8 rad about y) at its N = 40 knots x 10
# iterations from rest; the final attitude error below ILQR_BALL_BAR, on the
# card and with its tape shot on the CPU
ILQR_BALL = dict(knots=40, iterations=10, angle=0.4)
ILQR_BALL_BAR = 0.01
# Contacts of condim 4 and 6, elliptic cones over mixed condims, the RK4,
# implicit and implicitfast integrators. soft_feet: the main path's
# quadruped with condim-4 feet (soft_feet_xml: nefc 144 pyramidal, kernel 5),
# soft_feet_elliptic: the same compiled elliptic (condims 3 and 4, the
# general elliptic solve, its Hessian solves through kernel 3),
# condim6_elliptic: every pair condim 6, elliptic (condim6_xml: one
# contiguous cdim-6 tail, nefc 192, kernel 6); each from initial_batch under
# pd_ctrl. quadruped_implicitfast / _implicit / _rk4: the main path's model
# with Option.integrator set. Envs x steps per path below.
SOFT_FEET_STEPS, SOFT_ELLIPTIC_STEPS, CONDIM6_STEPS = 100, 50, 100
# quadruped_cg: the main path's quadruped loaded with solver="CG" through
# the port's utils/io_utils override, at its own 3 x 6 iterations;
# quadruped_noslip: the same model under Newton with noslip_iterations="3"
# (tests/test_torch_bridge.py's NOSLIP_XML), its default noslip_tolerance.
# Both from initial_batch under pd_ctrl; card vs CPU at CONVERGED: at the
# own 3 x 6 the CPU's own 8-env rollout moves, after 20 steps under a 1e-6
# nudge of its start, 7.6e-2 in qpos and 0.71 in qvel (CG) and 1.9e-2 and
# 0.40 (noslip), at CONVERGED 2.1e-5 / 1.0e-3 and 3.4e-6 / 6.4e-4.
CG_STEPS = NOSLIP_STEPS = 50
# quadruped_fluid: the main path's quadruped in tests/test_fluid.py:21's
# medium (FLUID_MEDIUM) under implicitfast, gravcomp 1 on its eight thigh
# and calf bodies, a trackcom camera and a targetbody light on the trunk,
# a site at each foot and four CAMPROJECTION sensors of them in the camera
# (quadruped_fluid_xml); quadruped_dr: the main path's quadruped with
# per-env leaves (rl.quadruped.randomize_quadruped drawn from a CPU
# generator seeded DR_SEED: trunk mass, leg damping, foot friction, motor
# gains). Both 4096 envs x 50 steps from initial_batch under pd_ctrl; card
# vs CPU 8 x 20 at QPOS_TOL / QVEL_TOL, quadruped_dr from its start, the
# fluid path from its settled final state at its own 3 x 6 ("settled"):
# from the start its feet land, and the CPU's own rollout moves 2.1e-2 in
# qvel under a 1e-6 nudge at 15 x 15 (6.3e-2 at 30 x 30), from the settled
# state 3.3e-4 at 3 x 6; and for quadruped_dr 8 envs of the batched-leaf
# rollout on the card against each env's own unbatched model over
# DR_CHECK_STEPS steps at tolerance 0.
FLUID_MEDIUM = 'density="1.2" viscosity="0.3" wind="0.5 -0.2 0.1"'
FLUID_STEPS = DR_STEPS = 50
DR_SEED, DR_CHECK_STEPS = 21, 10
# quadruped_dr_full: the same path with rl.quadruped.randomize_quadruped_full
# (randomize_quadruped's four leaves and eight more: leg friction loss and
# armature, the trunk's com offset and inertia, leg joint zero offsets
# (qpos0), the feet's solref, motor gear and forcerange); card vs CPU 8 x 20
# from its settled final state, and 8 envs against their own models at
# tolerance 0 within SAME_QPOS / SAME_QVEL (quadruped_dr's four leaves meet
# them bit for bit)
SAME_QPOS, SAME_QVEL = 1e-6, 1e-5
NOSLIP_RHS = 136  # the quadruped's nefc: M^-1 J^T's right-hand sides per env
# kernel 2 with k right-hand sides per factor: (B, n, k) cases beside the
# noslip shape, the warp design's edges and the block design at small B
RHS_CASES = ((257, 1, 5), (257, 31, 3), (8, 33, 4), (8, 192, 3))
# the JAX tests' fixtures of this slice, card against CPU (solver_fixtures)
NOSLIP_SCENE = lambda: tests_xml("test_noslip.py", "XML")  # noqa: E731
BALL_PLANE = lambda: tests_xml("test_constraint_parity.py", "BALL_PLANE")  # noqa: E731
NOSLIP_SCENE_OPT = dict(iterations=30, ls_iterations=30)
RK4, IMPLICIT, IMPLICITFAST = 1, 2, 3  # Option.integrator (ambersim_tpu_torch.core.types.IntegratorType)
# Cut for the fluid and per-env-leaf phases: implicitfast 100 -> 50 steps
# (kernel 3's check on its qM - h D reads any settled state), implicit
# 50 -> 25, RK4 25 -> 12 (nothing reads their final states)
IMPLICITFAST_STEPS, IMPLICIT_STEPS, RK4_STEPS = 50, 25, 12
# kernel 6 on tests/test_elliptic.py's spin-down sphere (condim 4, elliptic,
# friction 0.8 0.2 0.01, 30 x 30 iterations) at NUM_ENVS envs: spin
# SPIN_QVEL about the normal plus 0.5 N(0, 1) on every velocity
# (numpy.random.default_rng(19))
SPIN_QVEL = 6.0
# the actuator fixture: a position servo on a joint with an actuatorfrcrange
# clamp, a velocity servo, an intvelocity (integrator dynamics, act-limited),
# filter, filterexact (with an affine bias) and integrator actuators, and a
# motor in a disabled group; a keyframe sets qpos and the four activations;
# Newton 8 x 8 (its limit row needs no more)
ACTUATOR_RIG = """
<mujoco model="actuator_rig">
  <option timestep="0.004" iterations="8" ls_iterations="8" actuatorgroupdisable="3"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" axis="0 1 0" damping="0.1" actuatorfrcrange="-0.8 0.5"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04"/>
      <body pos="0.3 0 0">
        <joint name="j2" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.25 0 0" size="0.035"/>
        <body pos="0.25 0 0">
          <joint name="j3" type="slide" axis="1 0 0" damping="0.2" range="-0.2 0.2"/>
          <geom type="box" size="0.04 0.03 0.03"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position name="pos" joint="j1" kp="8" kv="0.5" forcerange="-3 3"/>
    <velocity name="vel" joint="j2" kv="2"/>
    <intvelocity name="intvel" joint="j3" kp="20" actrange="-0.3 0.3"/>
    <general name="filter" joint="j2" dyntype="filter" dynprm="0.05" gainprm="1.5" ctrlrange="-2 2"/>
    <general name="filterexact" joint="j1" dyntype="filterexact" dynprm="0.08" gainprm="2" biastype="affine"
             biasprm="0 -1 -0.1"/>
    <general name="integrator" joint="j3" dyntype="integrator" gainprm="4" actrange="-1 1" actlimited="true"/>
    <motor name="off" joint="j2" gear="3" group="3" ctrlrange="-1 1"/>
  </actuator>
  <sensor>
    <actuatorpos actuator="pos"/>
    <actuatorvel actuator="vel"/>
    <actuatorfrc actuator="filterexact"/>
    <actuatorfrc actuator="off"/>
    <jointactuatorfrc joint="j1"/>
    <jointlimitpos joint="j3"/>
    <jointlimitfrc joint="j3"/>
  </sensor>
  <keyframe>
    <key name="start" qpos="0.3 -0.2 0.1" act="0.1 -0.4 0.6 -0.9"/>
  </keyframe>
</mujoco>
"""
# the geom-distance trio on tests/test_distance_sensors.py's shapes (its
# spheres, box and capsules, a plane, two bodies' geoms, a cutoff the pair
# lies beyond and a zero cutoff), in one scene of free bodies that do not
# collide (the trio measures any two geoms)
DISTANCE_RIG = """
<mujoco model="distance_rig">
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="a" pos="0 0 1"><joint type="free"/><geom name="ga" type="sphere" size="0.1" mass="1"/>
      <geom name="ga2" type="sphere" size="0.05" pos="0.3 0 0" mass="1"/></body>
    <body name="b" pos="0.5 0.2 1.2"><joint type="free"/><geom name="gb" type="sphere" size="0.15" mass="1"/></body>
    <body name="c" pos="0.12 -0.05 0.9"><joint type="free"/><geom name="gc" type="box" size="0.1 0.12 0.14" mass="1"/></body>
    <body name="d" pos="-0.5 0 1"><joint type="free"/><geom name="gd" type="capsule" size="0.05 0.2" mass="1"/></body>
    <body name="e" pos="-0.2 0.3 1.1"><joint type="free"/>
      <geom name="ge" type="capsule" size="0.07 0.15" euler="30 20 0" mass="1"/>
      <geom name="ge2" type="box" size="0.05 0.05 0.05" pos="-0.2 0 0" mass="1"/></body>
  </worldbody>
  <sensor>
    <distance geom1="ga" geom2="gb" cutoff="2"/><normal geom1="ga" geom2="gb" cutoff="2"/>
    <fromto geom1="ga" geom2="gb" cutoff="2"/>
    <distance geom1="ga" geom2="gc" cutoff="2"/><normal geom1="ga" geom2="gc" cutoff="2"/>
    <fromto geom1="ga" geom2="gc" cutoff="2"/>
    <distance geom1="gd" geom2="ge" cutoff="2"/><fromto geom1="gd" geom2="ge" cutoff="2"/>
    <distance geom1="ge" geom2="ga" cutoff="2"/><normal geom1="ge" geom2="ga" cutoff="2"/>
    <distance geom1="floor" geom2="gb" cutoff="5"/><fromto geom1="floor" geom2="gb" cutoff="5"/>
    <distance body1="a" body2="e" cutoff="3"/><normal body1="a" body2="e" cutoff="3"/>
    <fromto body1="a" body2="e" cutoff="3"/>
    <distance geom1="gd" geom2="gb" cutoff="0.1"/><fromto geom1="gd" geom2="gb" cutoff="0.1"/>
    <distance geom1="ga" geom2="gc" cutoff="0"/>
  </sensor>
</mujoco>
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 10, calls: int = 10) -> float:
    """Milliseconds per call of `fn` on the card: CUDA events around `calls`
    back-to-back calls, median over `reps`. The calls queue behind a sleep
    kernel of SLEEP_CYCLES, so the host's time to enqueue them stays off the
    card's clock as long as it is shorter than the sleep; a function whose
    host time exceeds its device time (a plain version's many small ops)
    still shows the host's pace."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def plain_ms(fn) -> float:
    """cuda_ms of a plain version at PLAIN_REPS x PLAIN_CALLS."""
    return cuda_ms(fn, reps=PLAIN_REPS, calls=PLAIN_CALLS)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def linalg_bound(name: str, B: int, n: int, k: int = 1) -> dict:
    """Kernels 1-3 on B systems of size n, float32: each reads only the lower
    triangle of its (B, n, n) input, n(n+1)/2 floats a system; a factor
    writes the whole L, a solve reads and writes one (B, n) vector (kernel
    2: k of them against each factor, read once). n^3/3 operations for a
    factor and 2 n^2 for the two sweeps of each right-hand side."""
    tri, mat, vec = 4.0 * B * n * (n + 1) / 2, 4.0 * B * n * n, 4.0 * B * n
    if name == "cholesky":
        return bound(tri + mat, B * n**3 / 3)
    if name == "cho_solve":
        return bound(tri + 2 * vec * k, B * k * 2.0 * n * n)
    return bound(tri + 2 * vec, B * (n**3 / 3 + 2.0 * n * n))


def newton_bound(tensors, nefc: int, nv: int, act, iterations: int, ls_iterations: int) -> dict:
    """A Newton solve of B envs: its operand tensors read once, qacc,
    efc_force and qfrc_constraint written once; per iteration the Hessian
    over this run's mean active rows (2 n_active nv^2), its factor and solve
    (nv^3/3 + 2 nv^2), two row products (4 nefc nv) and ~10 operations per
    row and line-search step. act is the (B, nefc) row activity."""
    B = act.shape[0]
    n_active = act.float().sum(1).mean().item()
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + 4.0 * B * (2 * nv + nefc)
    per_iter = 2.0 * n_active * nv * nv + nv**3 / 3 + 2.0 * nv * nv + 4.0 * nefc * nv + 10.0 * nefc * ls_iterations
    return bound(nbytes, B * iterations * per_iter)


def max_err(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want|; fails unless every element is within atol + rtol * |want|."""
    import torch

    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{what}: max |kernel - plain| = {err.max().item():.3e} over rtol/atol {rtol}/{atol}")
    return float(err.max().item())


def newton_within(got: tuple, want: tuple):
    """(B,) bool: every component of (qacc, efc_force, qfrc_constraint)
    within rtol/atol NEWTON_TOL of want."""
    import torch

    within = torch.ones(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        within &= ((g - w).abs() <= NEWTON_TOL + NEWTON_TOL * w.abs()).all(dim=1)
    return within


NEWTON_OUTPUTS = ("qacc", "efc_force", "qfrc_constraint")


def newton_err(got: tuple, want: tuple, what: str, names: tuple = NEWTON_OUTPUTS) -> float:
    """Max |got - want| over (qacc, efc_force, qfrc_constraint), or the
    tensors `names` names; fails on the NEWTON_* bars above."""
    import torch

    err_max = 0.0
    for g, w, name in zip(got, want, names):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{what} {name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite output")
        g, w = g.double(), w.double()
        err = (g - w).abs()
        env_rel = err.amax(dim=1) / (w.abs().amax(dim=1) + NEWTON_TOL)
        if env_rel.max().item() > NEWTON_ENV_RTOL:
            fail(f"{what} {name}: an env differs by {env_rel.max().item():.3e} of its largest component")
        err_max = max(err_max, err.max().item())
    share = newton_within(got, want).float().mean().item()
    print(f"{what}: {share:.4f} of envs within rtol/atol {NEWTON_TOL}; max |difference| {err_max:.3e}")
    if share < NEWTON_MIN_SHARE:
        fail(f"{what}: only {share:.4f} of envs within rtol/atol {NEWTON_TOL}")
    return err_max


def vs_float64(got: tuple, plain: tuple, exact: tuple, what: str, within=newton_within, costs: tuple | None = None,
               slack: float = NEWTON_F64_SLACK, names: tuple = NEWTON_OUTPUTS) -> None:
    """Where plain float32 itself misses float64 beyond the bars' slack: the
    kernel's outputs `got` must be finite, and its share of envs within
    `exact` (the float64 solve) by `within` (newton_within: rtol/atol
    NEWTON_TOL on every component) may fall short of the plain float32
    solve's (`plain`) by at most `slack`. With `costs` (kernel, plain
    float32 and float64 total costs per env), at most ELLIPTIC_COST_ENVS
    envs' kernel cost may exceed the larger of plain float32's and
    float64's by more than ELLIPTIC_COST_RTOL of max(|cost|, 1)."""
    import torch

    for g, name in zip(got, names):
        if not torch.isfinite(g).all():
            fail(f"{what} {name}: non-finite kernel output")
    k_plain, p_exact, k_exact = (within(a, b).double().mean().item()
                                 for a, b in ((got, plain), (plain, exact), (got, exact)))
    line = (f"{what}: share of envs within: kernel-plain {k_plain:.4f}, plain-f64 {p_exact:.4f}, "
            f"kernel-f64 {k_exact:.4f}")
    if k_exact < p_exact - slack:
        fail(f"{line}: the kernel meets float64 on fewer envs than plain float32, by more than {slack}")
    if costs is not None:
        c_k, c_p, c_e = costs
        ref = torch.maximum(c_p, c_e)
        excess = (c_k - ref) / ref.abs().clamp(min=1.0)
        over = int((excess > ELLIPTIC_COST_RTOL).sum())
        line += (f"; {over} envs' kernel cost over max(plain, float64) by more than {ELLIPTIC_COST_RTOL} "
                 f"(largest excess {excess.max().item():.3e})")
        if over > ELLIPTIC_COST_ENVS:
            fail(f"{line}: more than {ELLIPTIC_COST_ENVS}")
    print(line)


def env_rel_err(got: tuple, want: tuple, what: str):
    """Per-env max |got - want| / (max |want| + 1) over (qacc, efc_force,
    qfrc_constraint), as a (B,) float64 tensor, and the max |difference|."""
    import torch

    rel = torch.zeros(got[0].shape[0], dtype=torch.float64, device=got[0].device)
    err_max = 0.0
    for g, w, name in zip(got, want, ("qacc", "efc_force", "qfrc_constraint")):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{what} {name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite output")
        err = (g.double() - w.double()).abs()
        rel = torch.maximum(rel, err.amax(dim=1) / (w.double().abs().amax(dim=1) + 1.0))
        err_max = max(err_max, err.max().item())
    return rel, err_max


def random_spd(rng, B: int, n: int, device):
    import numpy as np
    import torch

    g = rng.standard_normal((B, n, n)).astype(np.float32)
    a = g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((B, n)).astype(np.float32)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


class _Skel:
    """Just the skeleton fields PyramidStructure reads (hashable by identity)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def synthetic_structured_problem(B: int, seed: int, device, nv: int = 12, active: float = 0.8,
                                 d_range: tuple = (1.0, 10.0)):
    """A numpy-seeded pyramidal Newton problem with every row family of the
    structured layout: 2 equality rows, dof-friction and 2 tendon-friction
    rows, scalar limits (one-hot) and, from nv = 7, one ball limit (dense),
    and condim-3 contacts (5; 36 at nv = 32, past one warp's 32 lanes). The
    joints: hinge, ball, hinge at dofs 2, 5, 9 from nv = 12; at dofs 2, 3, 6
    from nv = 7; one hinge at dof 0 below. Returns (structure, args of
    engine.solver._newton_arrays, kernel-only operands bJ and dsc)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core.types import EqType, JointType
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    # each row is active with chance `active`, and D is uniform on d_range
    ncon = 36 if nv >= 32 else 5
    if nv >= 7:
        jnt_type = np.array([JointType.HINGE, JointType.BALL, JointType.HINGE], np.int32)
        dofadr, fric_dofs = ([2, 5, 9], [0, 4, 7]) if nv >= 12 else ([2, 3, 6], [0, 4, 6])
    else:
        jnt_type, dofadr, fric_dofs = np.array([JointType.HINGE], np.int32), [0], [0]
    nrows = 2 + len(fric_dofs) + 2 + len(jnt_type)  # equality, dof and tendon friction, limits
    s = _Skel(
        nefc=nrows + 4 * ncon, ncon=ncon, neq=2, eq_type=np.array([EqType.JOINT, EqType.JOINT], np.int32),
        friction_dofid=np.array(fric_dofs, np.int32), friction_tenid=np.array([0, 1], np.int32),
        limit_jntid=np.arange(len(jnt_type), dtype=np.int32), jnt_type=jnt_type,
        jnt_dofadr=np.array(dofadr, np.int32), limit_tenid=np.array([], np.int32),
        con_dim=np.full(ncon, 3, np.int32), con_efcadr=(nrows + 4 * np.arange(ncon)).astype(np.int32),
    )
    st = _pyramid_structure(s)
    assert st is not None and (st.ncon3, st.nd_eq, st.nd_ft, st.nfd) == (ncon, 2, 2, len(fric_dofs))

    rng = np.random.default_rng(seed)
    f32 = np.float32
    J = np.zeros((B, s.nefc, nv), f32)
    J[:, st.dense_rows] = rng.standard_normal((B, st.nd, nv))
    dsc = rng.choice([-1.0, 1.0], (B, st.ndiag)).astype(f32)
    dsc[:, : st.nfd] = 1.0
    J[:, st.diag_rows, st.diag_dofs] = dsc
    N, U1, U2 = (rng.standard_normal((B, ncon, nv)).astype(f32) for _ in range(3))
    for q, row in enumerate((N + U1, N - U1, N + U2, N - U2)):
        J[:, st.adr3 + q] = row
    bJ = np.concatenate([N, U1, U2], axis=1)
    g = rng.standard_normal((B, nv, nv)).astype(f32)
    qM = g @ np.swapaxes(g, -1, -2) / nv + np.eye(nv, dtype=f32)
    aref = rng.standard_normal((B, s.nefc)).astype(f32)
    D = rng.uniform(*d_range, (B, s.nefc)).astype(f32)
    fl = np.zeros((B, s.nefc), f32)
    fric_rows = np.concatenate([st.diag_rows[: st.nfd], st.dense_rows[st.nd_eq : st.nd_eq + st.nd_ft]])
    fl[:, fric_rows] = rng.uniform(0.1, 1.0, (B, len(fric_rows)))
    act = (rng.uniform(size=(B, s.nefc)) < active).astype(f32)
    a_s = rng.standard_normal((B, nv)).astype(f32)
    ws = a_s + 0.3 * rng.standard_normal((B, nv)).astype(f32)

    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    plain_args = dict(
        J=t(J), qM=t(qM), aref=t(aref), D=t(D), fl=t(fl), act=t(act), a_s=t(a_s), ws=t(ws),
        tol=torch.full((1,), 1e-8, device=device), ne=st.nd_eq, nf=st.nfd + st.nd_ft,
    )
    return st, plain_args, t(bJ), t(dsc)


def nonfinite_row_line_search(pa: dict, env: int, r: int) -> None:
    """Make env `env` of a Newton problem one whose line search goes
    non-finite in float32, in place: its last dof j moves nothing but row r,
    a Huber friction row put in its linear zone with J_rj = 1e31, so
    H_jj = 1e-8, the gradient's j is 1e31 and the Newton direction's is
    1e39, past float32: inf there, NaN in the other dofs after the backward
    sweep, and so a step that kernels 4 and 5 select to 0 and kernel 6's
    bracket takes to 0, with a NaN trial cost. Every iteration keeps the
    start (qacc_smooth or the warmstart)."""
    j = pa["J"].shape[2] - 1
    pa["J"][env, :, j] = 0.0
    pa["J"][env, r, j] = 1e31
    pa["qM"][env, j, :] = 0.0
    pa["qM"][env, :, j] = 0.0
    pa["a_s"][env, j] = pa["ws"][env, j] = 0.0
    pa["fl"][env, r], pa["act"][env, r], pa["D"][env, r], pa["aref"][env, r] = 1.0, 1.0, 10.0, 20.0


def nonfinite_line_search(st, pa: dict, bJ, env: int) -> None:
    """nonfinite_row_line_search on env `env` of a
    synthetic_structured_problem (nv >= 12), through its first tendon
    friction row, and the basis likewise."""
    j = pa["J"].shape[2] - 1
    assert j not in set(int(x) for x in st.diag_dofs)
    bJ[env, :, j] = 0.0
    nonfinite_row_line_search(pa, env, int(st.dense_rows[st.nd_eq]))


def kept_start(got, want, pa: dict, env: int, use_ws: bool) -> bool:
    """Env `env` of kernel outputs `got` kept its start bit for bit
    (qacc_smooth, or the warmstart when use_ws), as the plain version's
    `want` did."""
    import torch

    starts = (pa["a_s"][env], pa["ws"][env]) if use_ws else (pa["a_s"][env],)
    return torch.equal(got[0][env], want[0][env]) and any(torch.equal(got[0][env], x) for x in starts)


def first_envs(pa: dict, b: int) -> dict:
    """The first b envs of a problem's batch operands."""
    import torch

    B = pa["J"].shape[0]
    return {k: v[:b].contiguous() if torch.is_tensor(v) and v.dim() and v.shape[0] == B else v for k, v in pa.items()}


def synthetic_dense_problem(B: int, nv: int, seed: int, device, active: float = 0.8,
                            d_range: tuple = (1.0, 10.0)) -> dict:
    """A numpy-seeded pyramidal Newton problem on dense rows: 2 equality
    rows, 3 Huber friction rows and 2 nv + 3 one-sided rows, each active
    with chance `active`, D uniform on d_range. Returns the arguments of
    engine.solver._newton_arrays (and of ops.newton.newton_solve_dense)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    ne, nf = 2, 3
    nefc = ne + nf + 2 * nv + 3
    g = rng.standard_normal((B, nv, nv)).astype(f32)
    fl = np.zeros((B, nefc), f32)
    fl[:, ne : ne + nf] = rng.uniform(0.1, 1.0, (B, nf))
    a_s = rng.standard_normal((B, nv)).astype(f32)
    arrays = dict(
        J=rng.standard_normal((B, nefc, nv)).astype(f32),
        qM=g @ np.swapaxes(g, -1, -2) / nv + np.eye(nv, dtype=f32),
        aref=rng.standard_normal((B, nefc)).astype(f32),
        D=rng.uniform(*d_range, (B, nefc)).astype(f32),
        fl=fl,
        act=(rng.uniform(size=(B, nefc)) < active).astype(f32),
        a_s=a_s,
        ws=a_s + 0.3 * rng.standard_normal((B, nv)).astype(f32),
    )
    out = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    return dict(out, tol=torch.full((1,), 1e-8, device=device), ne=ne, nf=nf)


def synthetic_elliptic_problem(B: int, nv: int, nh: int, S: int, cdim: int, seed: int, device) -> dict:
    """A numpy-seeded elliptic Newton problem: nh head rows (one equality,
    two Huber friction rows, the rest one-sided; none when nh = 0) and S
    cone blocks of cdim rows in MuJoCo order, impratio 2, contacts spread
    over all three zones. Returns the arguments of
    engine.solver._newton_arrays_elliptic (and of
    ops.newton.newton_solve_elliptic)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    ne, nf = (1, 2) if nh else (0, 0)
    nefc = nh + S * cdim
    impratio = 2.0
    fr = np.zeros((B, S, 5), f32)
    fr[..., : cdim - 1] = rng.uniform(0.3, 1.2, (B, S, cdim - 1))
    D = rng.uniform(1.0, 10.0, (B, nefc)).astype(f32)
    D_c = D[:, nh:].reshape(B, S, cdim)
    D_c[..., 1:] = D_c[..., :1] * impratio * (fr[..., : cdim - 1] / fr[..., :1]) ** 2
    D[:, nh:] = D_c.reshape(B, -1)
    fl = np.zeros((B, nefc), f32)
    fl[:, ne : ne + nf] = rng.uniform(0.1, 1.0, (B, nf))
    act = (rng.uniform(size=(B, nefc)) < 0.8).astype(f32)
    act[:, nh:] = np.repeat((rng.uniform(size=(B, S)) < 0.8).astype(f32), cdim, axis=1)
    g = rng.standard_normal((B, nv, nv)).astype(f32)
    a_s = rng.standard_normal((B, nv)).astype(f32)
    arrays = dict(
        J=rng.standard_normal((B, nefc, nv)).astype(f32),
        qM=g @ np.swapaxes(g, -1, -2) / nv + np.eye(nv, dtype=f32),
        aref=2.0 * rng.standard_normal((B, nefc)).astype(f32),
        D=D, fl=fl, act=act, a_s=a_s,
        ws=a_s + 0.3 * rng.standard_normal((B, nv)).astype(f32),
        fr=fr,
    )
    out = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    return dict(out, tol=torch.full((1,), 1e-8, device=device), impratio=torch.tensor(impratio, device=device),
                ne=ne, nf=nf, base=nh, ncon=S, cdim=cdim)


def selection_case(device, row_cap: bool, B: int = 4, nspheres: int = 300, k: int = 8, ncon: int = 10):
    """A synthetic scene past 256 geoms for the selection checks: the floor
    and `nspheres` spheres of radius 0.01 (geom ids 1..nspheres), two capped
    groups of k slots (plane-sphere and every sphere-sphere pair) and, with
    `row_cap`, a row cap of ncon. Sphere 261-270 stand 2-20 mm deep in the
    floor and spheres 281-300 overlap in pairs by 1-10 mm, in an order drawn
    per env; the others sit on a jittered 0.1 m grid far from everything.
    Built from the clutter asset's geom parameters and numpy-seeded geom
    poses, without JAX. Returns (model, Data after the poses, the model
    without the row cap, the expected (B, k) geom ids of both groups)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data

    base = load_model("clutter32_cap48", device=device)
    G = nspheres + 1
    rng = np.random.default_rng(21)
    ss1, ss2 = np.triu_indices(nspheres, 1)
    pair_g1 = np.concatenate([np.zeros(nspheres, np.int32), ss1 + 1]).astype(np.int32)
    pair_g2 = np.concatenate([np.arange(1, G), ss2 + 1]).astype(np.int32)

    def floor_and_spheres(x):  # the floor's entry, then sphere geom 1's for every sphere
        return torch.cat([x[:1], x[1:2].expand((nspheres,) + tuple(x.shape[1:]))])

    leaves = {f: floor_and_spheres(getattr(base, f)) for f in (
        "geom_priority", "geom_solmix", "geom_solref", "geom_solimp", "geom_friction", "geom_margin", "geom_gap")}
    leaves["geom_size"] = torch.tensor([[0.0, 0.0, 1.0]] + [[0.01, 0.0, 0.0]] * nspheres, device=device)
    leaves["geom_rbound"] = torch.tensor([0.0] + [0.01] * nspheres, device=device)
    ncand = 2 * k
    skel = base.skel.replace(
        ngeom=G, geom_type=np.array([0] + [2] * nspheres, np.int32), pair_geom1=pair_g1, pair_geom2=pair_g2,
        pair_ctype1=np.where(pair_g1 == 0, 0, 2).astype(np.int32), pair_ctype2=np.full(len(pair_g1), 2, np.int32),
        pair_explicit=np.full(len(pair_g1), -1, np.int32), con_adr=np.full(len(pair_g1), -1, np.int32),
        con_geom1=np.zeros(ncand, np.int32), con_geom2=np.zeros(ncand, np.int32),
        bpg_type1=np.array([0, 2], np.int32), bpg_type2=np.array([2, 2], np.int32),
        bpg_adr=np.array([0, k], np.int32), bpg_nsel=np.array([k, k], np.int32), ncand=ncand, ncon=ncand,
    )
    m_all = base.replace(skel=skel, **leaves)
    m = m_all.replace(skel=skel.replace(ncon=ncon)) if row_cap else m_all

    grid = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"), -1).reshape(-1, 3)[:nspheres]
    pos = np.zeros((B, G, 3))
    pos[:, 1:] = 0.1 * grid + np.array([0.0, 0.0, 0.3]) + rng.uniform(-0.02, 0.02, (B, nspheres, 3))
    floor_ids, pair_ids = np.arange(261, 271), np.arange(281, 301).reshape(10, 2)
    want = np.zeros((B, 2, k, 2), np.int64)
    for b in range(B):
        depth = rng.permutation(10)
        pos[b, floor_ids] = np.stack([0.05 * np.arange(10), np.full(10, -1.0), 0.008 - 0.002 * depth], -1)
        want[b, 0, :, 1] = floor_ids[np.argsort(0.008 - 0.002 * depth, kind="stable")[:k]]
        overlap = 0.001 * (1 + rng.permutation(10))
        for q, (i, j) in enumerate(pair_ids):
            pos[b, i] = np.array([0.05 * q, 1.0, 0.5])
            pos[b, j] = pos[b, i] + np.array([0.02 - overlap[q], 0.0, 0.0])
        want[b, 1] = pair_ids[np.argsort(-overlap, kind="stable")[:k]]
    d = make_data(m, B)
    d = d.replace(geom_xpos=torch.as_tensor(pos.astype(np.float32), device=device),
                  geom_xmat=torch.eye(3, device=device).expand(B, G, 3, 3).contiguous())
    return m, d, m_all, torch.as_tensor(want, device=device)


def check_selection_exact(device, row_cap: bool) -> None:
    """The broadphase top-k and the row cap move geom ids above 256 and
    contact distances bit for bit (selection_case): the capped slots hold the
    expected pairs and exactly the distances their narrowphase gives, and
    the row cap's rows are exactly the uncapped slots of the ncon largest
    includemargin - dist, ties lowest slot first. On the card it runs with
    TF32 matmuls allowed, so a selection spelled as a product would fail.
    Raises AssertionError."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import collision
    from ambersim_tpu_torch.engine.forward import full_f32_matmul

    with full_f32_matmul():  # gives the caller's TF32 flags back on exit
        torch.backends.cuda.matmul.allow_tf32 = device.type == "cuda"
        m, d, m_all, want = selection_case(device, row_cap)
        got = collision.collision(m_all, d).contact
        k = want.shape[2]
        for grp, fn in ((0, collision.plane_sphere), (1, collision.sphere_sphere)):
            sl = slice(grp * k, (grp + 1) * k)
            g1, g2 = want[:, grp, :, 0], want[:, grp, :, 1]
            if not (torch.equal(got.geom1[:, sl].long(), g1) and torch.equal(got.geom2[:, sl].long(), g2)):
                raise AssertionError(f"group {grp}: selected geom ids {got.geom2[:, sl].tolist()}, want {g2.tolist()}")
            poses = [torch.take_along_dim(x, g[(...,) + (None,) * (x.dim() - 2)], dim=1)
                     for g in (g1, g2) for x in (d.geom_xpos, d.geom_xmat)]
            dist = fn(poses[0], poses[1], m.geom_size[g1], poses[2], poses[3], m.geom_size[g2])[0][..., 0]
            if not torch.equal(got.dist[:, sl], dist):
                raise AssertionError(f"group {grp}: contact distances changed by the selection")
        if int(want.max()) <= 256:
            raise AssertionError("no geom id above 256 selected")
        if row_cap:
            capped = collision.collision(m, d).contact
            key = (got.includemargin - got.dist).cpu().numpy()
            order = torch.as_tensor(np.argsort(-key, axis=1, kind="stable")[:, : m.skel.ncon], device=device)
            for f in ("dist", "pos", "frame", "friction", "includemargin", "geom1", "geom2"):
                x = getattr(got, f)
                if not torch.equal(getattr(capped, f), torch.take_along_dim(
                        x, order[(...,) + (None,) * (x.dim() - 2)], dim=1)):
                    raise AssertionError(f"row cap: contact.{f} is not the uncapped slots' at the deepest rows")


def check_linalg(device, results):
    """Kernels 1-3 against their plain versions: the warp kernels at every
    n <= 32 (kernel 3 also on systems at storage offset 1, which take its
    window copy, with the aligned copy's bits), the block kernels at
    LARGE_NS on the clutter width and at LARGE_BATCH systems of n = 192;
    each leaves the upper triangle unread and L zero above the diagonal.
    A zero pivot (ZERO_PIVOT_ROWS) as the plain version treats it, and at
    least two resident blocks per SM for each block kernel at n = 192.
    Times (and the library calls': torch.linalg.cholesky_ex, which checks
    nothing on the host, torch.cholesky_solve) at the main path's (4096, 18)
    and the clutter path's (256, 192)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(1)
    errs = {k: 0.0 for k in _LINALG + _LINALG_BLOCK}
    timed = {(NUM_ENVS, 18), (CLUTTER_ENVS, 192)}
    sizes = ((NUM_ENVS, 18),) + tuple((257, n) for n in range(1, kernels.MAX_N_WARP + 1))
    sizes += tuple((CLUTTER_ENVS, n) for n in LARGE_NS)
    sizes += ((LARGE_BATCH, kernels.MAX_N),)
    # and at every (batch, n) a phase launches them at
    sizes += tuple(sorted({shape for shape, _ in PHASE_SHAPES.values() if len(shape) == 2} - set(sizes)))
    for B, n in sizes:
        tol = LINALG_TOL if n <= kernels.MAX_N_WARP else LARGE_LINALG_TOL
        a, b = random_spd(rng, B, n, device)
        l_ref = plain.cholesky_unrolled(a)
        cases = {
            "cholesky": (lambda: kernels.cholesky_batched(a), lambda: plain.cholesky_unrolled(a),
                         lambda: torch.linalg.cholesky_ex(a).L),
            "cho_solve": (lambda: kernels.cho_solve_batched(l_ref, b), lambda: plain.cho_solve_unrolled(l_ref, b),
                          lambda: torch.cholesky_solve(b[..., None], l_ref)[..., 0]),
            "solve_pd": (lambda: kernels.solve_pd_batched(a, b), lambda: plain.solve_pd_unrolled(a, b),
                         lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(a).L)[..., 0]),
        }
        for name, (kern, ref, lib) in cases.items():
            key = name if n <= kernels.MAX_N_WARP else f"{name}_block"
            got, want = kern(), ref()
            torch.cuda.synchronize()
            errs[key] = max(errs[key], max_err(got, want, tol, tol, f"{key} B={B} n={n}"))
            if (B, n) in timed:
                ms, plain_t, library_ms = cuda_ms(kern), plain_ms(ref), cuda_ms(lib)
                results[key].update(ms=ms, plain_ms=plain_t, library_ms=library_ms, **linalg_bound(name, B, n))
                print(f"kernel {key}: B={B} n={n} {ms:.4f} ms, plain {plain_t:.4f} ms, library {library_ms:.4f} ms, "
                      f"bound {results[key]['bound_ms']:.4f} ms ({results[key]['bound_by']})")
        # the kernels read only the lower triangle (the contract kernel 4 relies on)
        a_low = torch.tril(a) + torch.triu(torch.full_like(a, 1e6), diagonal=1)
        l_got = kernels.cholesky_batched(a)
        max_err(kernels.cholesky_batched(a_low), l_got, 0.0, 0.0, f"upper triangle n={n}")
        max_err(kernels.solve_pd_batched(a_low, b), kernels.solve_pd_batched(a, b), 0.0, 0.0, f"upper triangle solve n={n}")
        l_low = l_ref + torch.triu(torch.full_like(l_ref, 1e6), diagonal=1)
        max_err(kernels.cho_solve_batched(l_low, b), kernels.cho_solve_batched(l_ref, b), 0.0, 0.0,
                f"upper triangle cho_solve n={n}")
        if torch.triu(l_got, diagonal=1).abs().max().item() != 0.0:
            fail(f"cholesky n={n}: nonzero above the diagonal")
        if n <= kernels.MAX_N_WARP:  # systems that do not start 16-byte aligned: kernel 3's window copy
            a_off = torch.empty(a.numel() + 1, device=device)[1:].view_as(a).copy_(a)
            x_off = kernels.solve_pd_batched(a_off, b)
            errs["solve_pd"] = max(errs["solve_pd"], max_err(x_off, plain.solve_pd_unrolled(a_off, b), tol, tol,
                                                             f"solve_pd at storage offset 1 n={n}"))
            max_err(x_off, kernels.solve_pd_batched(a, b), 0.0, 0.0, f"solve_pd at storage offset 1 vs aligned n={n}")
    # a zero pivot: the factor matches the plain version (L_jj = 0 exactly),
    # and the solve is non-finite exactly where the plain version's is
    for n in (18, kernels.MAX_N_WARP, 100, kernels.MAX_N):
        a, b = random_spd(rng, len(ZERO_PIVOT_ROWS), n, device)
        rows = [min(j, n - 1) for j in ZERO_PIVOT_ROWS]
        for s, j in enumerate(rows):
            a[s, j, :] = 0.0
            a[s, :, j] = 0.0
        l_got = kernels.cholesky_batched(a)
        tol, key = (LINALG_TOL, "cholesky") if n <= kernels.MAX_N_WARP else (LARGE_LINALG_TOL, "cholesky_block")
        err = max_err(l_got, plain.cholesky_unrolled(a), tol, tol, f"zero pivot n={n}")
        errs[key] = max(errs[key], err)
        if any(l_got[s, j, j].item() != 0.0 for s, j in enumerate(rows)):
            fail(f"zero pivot n={n}: L_jj is not 0")
        x_got, x_want = kernels.solve_pd_batched(a, b), plain.solve_pd_unrolled(a, b)
        if not torch.equal(torch.isfinite(x_got), torch.isfinite(x_want)):
            fail(f"zero pivot solve n={n}: non-finite entries differ from the plain version's")
        y_got, y_want = kernels.cho_solve_batched(l_got, b), plain.cho_solve_unrolled(l_got, b)
        if not torch.equal(torch.isfinite(y_got), torch.isfinite(y_want)):
            fail(f"zero pivot cho_solve n={n}: non-finite entries differ from the plain version's")
        print(f"zero pivot n={n} (row/column {rows} zero): factor within {err:.2e} of plain, L_jj = 0; solve "
              f"non-finite in {int((~torch.isfinite(x_got)).sum())} entries, cho_solve in "
              f"{int((~torch.isfinite(y_got)).sum())}, as the plain version")
    for k in _LINALG + _LINALG_BLOCK:
        print(f"kernel {k}: max |kernel - plain| {errs[k]:.2e}")
        results[k]["max_abs_err"] = errs[k]
    # the block kernels must keep two systems resident on every SM at n = 192
    occupancy = {k: kernels.block_occupancy(k, kernels.MAX_N) for k in _LINALG_BLOCK}
    print(f"block kernels at n={kernels.MAX_N}: resident blocks per SM {occupancy}")
    for k in occupancy:
        if occupancy[k] < 2:
            fail(f"{k}: {occupancy[k]} resident blocks per SM at n = {kernels.MAX_N}, want >= 2")
    # past the block kernels' n the launchers refuse, on the card too
    a, b = random_spd(rng, 2, kernels.MAX_N + 1, device)
    try:
        kernels.solve_pd_batched(a, b)
    except ValueError:
        pass
    else:
        fail(f"solve_pd_batched took n = {kernels.MAX_N + 1}")
    # the times at every shape the paths launch kernels 1-3 at
    time_linalg_shapes(rng, {shape for shape, _ in PHASE_SHAPES.values()}, device)


def time_linalg_shapes(rng, shapes, device) -> None:
    """Kernels 1-3's times and bounds at each (B, n) of `shapes` into
    SHAPE_TIMES (for weighted_launch_time); a (B, n, k) shape times kernel 2
    alone, with k right-hand sides per factor."""
    import torch

    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.ops import linalg as kernels

    for shape in sorted(shapes):
        if len(shape) == 3:
            B, n, k = shape
            l_ref = plain.cholesky_unrolled(random_spd(rng, B, n, device)[0])
            rhs = torch.as_tensor(rng.standard_normal((B, k, n)).astype("float32"), device=device)
            key = "cho_solve" if n <= kernels.MAX_N_WARP else "cho_solve_block"
            SHAPE_TIMES[(key, shape)] = (cuda_ms(lambda: kernels.cho_solve_batched(l_ref, rhs)),
                                         linalg_bound("cho_solve", B, n, k)["bound_ms"])
            print(f"kernel {key} at B={B} n={n} k={k}: {SHAPE_TIMES[(key, shape)][0]:.4f} ms "
                  f"(bound {SHAPE_TIMES[(key, shape)][1]:.4f})")
            continue
        B, n = shape
        a, b = random_spd(rng, B, n, device)
        l_ref = plain.cholesky_unrolled(a)
        for name, kern in (("cholesky", lambda: kernels.cholesky_batched(a)),
                           ("cho_solve", lambda: kernels.cho_solve_batched(l_ref, b)),
                           ("solve_pd", lambda: kernels.solve_pd_batched(a, b))):
            key = name if n <= kernels.MAX_N_WARP else f"{name}_block"
            SHAPE_TIMES[(key, (B, n))] = (cuda_ms(kern), linalg_bound(name, B, n)["bound_ms"])
        print(f"kernels 1-3 at B={B} n={n}: " + ", ".join(
            f"{k} {SHAPE_TIMES[(k, (B, n))][0]:.4f} ms (bound {SHAPE_TIMES[(k, (B, n))][1]:.4f})"
            for k in ((f"{x}_block" if n > kernels.MAX_N_WARP else x) for x in _LINALG)))


def pre_solve(m, d):
    """The step up to the constraint solve (forward.forward without `solve`)."""
    from ambersim_tpu_torch.engine import collision, constraint, smooth

    d = smooth.fwd_position_smooth(m, d)
    d = collision.collision(m, d)
    d = constraint.make_constraint(m, d)
    return smooth.fwd_acceleration(m, smooth.fwd_actuation(m, smooth.fwd_velocity(m, d)))


def solver_operands(m, d, seed: int) -> dict:
    """Pre-solve operands of engine.solver's plain versions, with a warmstart
    of qacc_smooth + 0.1 N(0, 1) drawn by numpy.random.default_rng(seed)."""
    import numpy as np
    import torch

    s = m.skel
    ws = d.qacc_smooth + 0.1 * torch.as_tensor(
        np.random.default_rng(seed).standard_normal(d.qacc_smooth.shape).astype(np.float32), device=d.qpos.device
    )
    return dict(
        J=d.efc_J, qM=d.qM, aref=d.efc_aref, D=d.efc_D, fl=d.efc_frictionloss, act=d.efc_active.float(),
        a_s=d.qacc_smooth, ws=ws, tol=(m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(), min=1.0)).reshape(1),
    )


def as_dtype(args: dict, dtype) -> dict:
    import torch

    return {k: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v for k, v in args.items()}


def check_newton(device, results):
    """Kernel 4 against its plain version (and both against the plain version
    in float64) on the quadruped's pre-solve operands at 4096 envs and the
    humanoid's at 1024, then on synthetic problems with every row family:
    at nv = 12 and 257 envs against plain float32, and at NEWTON_NVS and
    4096 envs both against float64 (vs_float64) and, eased
    (SYNTHETIC_EASED), against plain float32 with the warmstart on and off
    and one env whose line search goes non-finite (nonfinite_line_search);
    the first 257 and the first 1 of the eased envs alone must give the same
    bits as in the whole batch (B not a multiple of the envs a block holds).
    Also the envs resident per SM at the quadruped's and humanoid's shapes:
    all 4096 quadruped envs must fit in two waves."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured, structured_occupancy

    def kern(pa, bJ, dsc, st, **kw):
        return newton_solve_structured(pa["J"], bJ, dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"],
                                       pa["a_s"], pa["ws"], pa["tol"], st=st, **kw)

    err, timed = 0.0, {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name, B in (("quadruped", NUM_ENVS), ("humanoid", 1024)):
        m = load_model(name, device=device)
        s, p = m.skel, PATHS[name]
        st = _pyramid_structure(s)
        d = p["start"](m, B, device)
        d = pre_solve(m, d.replace(ctrl=p["ctrl"](d)) if p["ctrl"] else d)
        pa = solver_operands(m, d, seed=2)
        kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
        envs = structured_occupancy(s.nv, s.nefc, st)
        print(f"{name} pre-solve: active efc rows per env {pa['act'].sum(1).mean().item():.1f} of {s.nefc}; "
              f"newton_structured holds {envs} envs per SM ({sms} SMs)")
        if name == "quadruped" and 2 * sms * envs < B:
            fail(f"newton_structured: {envs} envs per SM take more than two waves for {B} envs")

        def ref(dtype=torch.float32, pa=pa, kw=kw, s=s):
            return _newton_arrays(**as_dtype(pa, dtype), ne=int(s.ne), nf=int(s.nf), **kw)

        got = kern(pa, d.efc_bJ, d.efc_dsc, st, **kw)
        err = max(err, newton_err(got, ref(), f"newton_structured {name}"))
        # the same solve in float64 shows how far float32 rounding alone moves
        # it: the kernel must stay as close to it as the NEWTON_* bars ask
        exact = ref(torch.float64)
        newton_err(ref(), exact, f"newton_structured {name}, plain float32 vs float64")
        newton_err(got, exact, f"newton_structured {name}, kernel vs plain float64")
        if name == "quadruped":
            operands = [d.efc_bJ, d.efc_dsc] + [pa[k] for k in ("qM", "aref", "D", "fl", "act", "a_s", "ws")]
            timed = dict(ms=cuda_ms(lambda: kern(pa, d.efc_bJ, d.efc_dsc, st, **kw)), plain_ms=plain_ms(ref),
                         **newton_bound(operands, s.nefc, s.nv, pa["act"], kw["iterations"], kw["ls_iterations"]))
            SHAPE_TIMES[("newton_structured", "quadruped")] = (timed["ms"], timed["bound_ms"])

    # dense, equality, tendon-friction and one-hot rows
    syn = dict(iterations=5, ls_iterations=8, use_ws=True)
    st, pa, bJ, dsc = synthetic_structured_problem(257, seed=3, device=device)
    err = max(err, newton_err(kern(pa, bJ, dsc, st, **syn), _newton_arrays(**pa, **syn), "newton_structured synthetic"))
    for nv in NEWTON_NVS:
        st, pa, bJ, dsc = synthetic_structured_problem(NUM_ENVS, seed=3 + nv, device=device, nv=nv)
        vs_float64(kern(pa, bJ, dsc, st, **syn), _newton_arrays(**pa, **syn),
                   _newton_arrays(**as_dtype(pa, torch.float64), **syn), f"newton_structured synthetic nv={nv}")

        st, pa, bJ, dsc = synthetic_structured_problem(NUM_ENVS, seed=3 + nv, device=device, nv=nv,
                                                       **SYNTHETIC_EASED)
        bad = 5  # an env of the first 257, so every slice below holds it
        if nv >= 12:
            nonfinite_line_search(st, pa, bJ, bad)
        for use_ws in (True, False):
            kw = dict(iterations=5, ls_iterations=8, use_ws=use_ws)
            what = f"newton_structured eased synthetic nv={nv} ws={use_ws}"
            got = kern(pa, bJ, dsc, st, **kw)
            want = _newton_arrays(**pa, **kw)
            err = max(err, newton_err(got, want, what))
            if nv >= 12 and not kept_start(got, want, pa, bad, use_ws):
                fail(f"{what}: the env whose line search goes non-finite left its start")
            for b in (257, 1):
                part = kern(first_envs(pa, b), bJ[:b].contiguous(), dsc[:b].contiguous(), st, **kw)
                if not all(torch.equal(x, y[:b]) for x, y in zip(part, got)):
                    fail(f"{what}: the first {b} envs alone differ from the same envs in the whole batch")
        print(f"newton_structured eased synthetic nv={nv}: warmstart on and off match plain; B = 257 and 1 match "
              f"B = {NUM_ENVS} bit for bit" + ("; the non-finite line search keeps its start" if nv >= 12 else ""))
    print(f"kernel newton_structured: quadruped B={NUM_ENVS} {timed['ms']:.4f} ms, plain {timed['plain_ms']:.4f} ms, "
          f"max |err| {err:.2e}")
    results["newton_structured"].update(max_abs_err=err, library_ms=None, **timed)


def hand_model(device, trajopt: bool = True):
    """The hand (assets/hand.npz) at the predictive-sampling workload's
    options (HAND_TRAJOPT, DisableBit.CONTACT), or at its own."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core.types import DisableBit

    m = load_model("hand", device=device)
    if trajopt:
        m = m.replace(opt=m.opt.replace(disableflags=m.opt.disableflags | DisableBit.CONTACT, **HAND_TRAJOPT))
    return m


def hand_start(m, batch: int, seed: int, scale: float):
    """(batch, nq) hand qpos: each joint that no equality row drives uniform
    over [0, scale] of its range (numpy.random.default_rng(seed)), each
    coupled joint where its joint equality row puts it."""
    import numpy as np
    import torch

    s = m.skel
    rng = np.random.default_rng(seed)
    lo, hi = (m.jnt_range[:, i].cpu().numpy() for i in (0, 1))
    q0 = m.qpos0.cpu().numpy()
    qpos = np.tile(q0, (batch, 1))
    adr = np.asarray(s.jnt_qposadr)
    qpos[:, adr] = lo + rng.uniform(0.0, scale, (batch, len(adr))) * (hi - lo)
    c = m.eq_data.cpu().numpy()
    for e in range(s.neq):
        qa1, qa2 = adr[s.eq_obj1id[e]], adr[s.eq_obj2id[e]]
        z = qpos[:, qa2] - q0[qa2]
        qpos[:, qa1] = q0[qa1] + c[e, 0] + z * (c[e, 1] + z * (c[e, 2] + z * (c[e, 3] + z * c[e, 4])))
    return torch.as_tensor(qpos.astype(np.float32), device=m.device)


def hand_cost(device, mpc: bool = False):
    """StaticGoalQuadraticCost of the hand: the sampler's (Q = 0.1 I, Qf =
    10 I), or MPC's (Q = Qf, joint angles 10, velocities 1e-3); R = 1e-3 I,
    goal f1_spread 0.8, f1_prox 0.5, the rest 0."""
    import torch

    from ambersim_tpu_torch.trajopt import StaticGoalQuadraticCost

    nx, nu = 16, 4
    xg = torch.zeros(nx, device=device)
    xg[0], xg[1] = 0.8, 0.5
    eye = torch.eye(nx, device=device)
    if mpc:
        Q = Qf = torch.diag(torch.tensor([10.0] * (nx // 2) + [1e-3] * (nx // 2), device=device))
    else:
        Q, Qf = 0.1 * eye, 10.0 * eye
    return StaticGoalQuadraticCost(Q=Q, Qf=Qf, R=1e-3 * torch.eye(nu, device=device), xg=xg)


def check_newton_hand(device, results):
    """Kernel 4 on the hand's pre-solve operands, the first model path with
    equality rows (nd_eq = 4), each after 20 steps of HAND_CLOSING_CTRL
    from hand_start: the predictive-sampling path's at its 100 envs
    (contacts disabled: the 192 contact rows inactive) against its plain
    version at the NEWTON_* bars, and both against the plain version in
    float64; the contacts-on path's at 1024 envs (condim-3 blocks beside
    the equality rows) against float64 with vs_float64. Then kernel 4's
    time at every batch the hand paths launch it at (SHAPE_TIMES)."""
    import torch

    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    err = results["newton_structured"]["max_abs_err"]
    for trajopt, B in ((True, HAND_SAMPLES), (False, HAND_CONTACT_ENVS)):
        m = hand_model(device, trajopt)
        s = m.skel
        st = _pyramid_structure(s)
        first_contact = int(min(s.con_efcadr))
        d = make_data(m, B).replace(qpos=hand_start(m, B, seed=9, scale=0.5 if trajopt else 1.0),
                                    ctrl=torch.tensor(HAND_CLOSING_CTRL, device=device).expand(B, -1).contiguous())
        d = pre_solve(m, rollout(m, d, 20))
        pa = solver_operands(m, d, seed=6)
        kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
        what = f"newton_structured hand {'trajopt' if trajopt else 'contacts'} B={B}"
        act = pa["act"]
        eq_on, con_on = act[:, : st.nd_eq].sum(1).mean().item(), act[:, first_contact:].sum(1).mean().item() / 4
        print(f"{what}: nd_eq {st.nd_eq}, ndiag {st.ndiag}, ncon3 {st.ncon3}; active per env: equality rows "
              f"{eq_on:.2f}, rows {act.sum(1).mean().item():.2f} of {s.nefc}, contacts {con_on:.2f}")
        if st.nd_eq != 4 or eq_on != 4 or (con_on != 0 if trajopt else con_on < 1):
            fail(f"{what}: the operands miss the rows this check is for")

        def kern(pa=pa, d=d, st=st, kw=kw):
            return newton_solve_structured(pa["J"], d.efc_bJ, d.efc_dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"],
                                           pa["act"], pa["a_s"], pa["ws"], pa["tol"], st=st, **kw)

        def ref(dtype=torch.float32, pa=pa, kw=kw, s=s):
            return _newton_arrays(**as_dtype(pa, dtype), ne=int(s.ne), nf=int(s.nf), **kw)

        got, exact = kern(), ref(torch.float64)
        if trajopt:
            err = max(err, newton_err(got, ref(), what))
            newton_err(ref(), exact, f"{what}, plain float32 vs float64")
            newton_err(got, exact, f"{what}, kernel vs plain float64")
        else:
            # at 4 x 8 iterations with contacts plain float32 itself misses
            # float64 on more envs than the NEWTON_* bars leave (1 of 16 on
            # the CPU): the kernel is held against float64 as on kernel 4's
            # hard synthetic problems
            vs_float64(got, ref(), exact, what)
        # kernel 4's time at each batch the hand paths launch it at: the
        # operands' envs repeated or cut to that batch
        for b in (HAND_SAMPLES, 1, HAND_MPC_BATCH, HAND_MPC_BATCH * HAND_SAMPLES) if trajopt else (B,):
            idx = torch.arange(b, device=device) % B
            pb = {k: v[idx].contiguous() if torch.is_tensor(v) and v.shape[0] == B else v for k, v in pa.items()}
            bJ, dsc = d.efc_bJ[idx].contiguous(), d.efc_dsc[idx].contiguous()

            def kb(pb=pb, bJ=bJ, dsc=dsc):
                return newton_solve_structured(pb["J"], bJ, dsc, pb["qM"], pb["aref"], pb["D"], pb["fl"], pb["act"],
                                               pb["a_s"], pb["ws"], pb["tol"], st=st, **kw)

            operands = [bJ, dsc] + [pb[k] for k in ("qM", "aref", "D", "fl", "act", "a_s", "ws")]
            case = f"hand B={b}" if trajopt else "hand contacts"
            SHAPE_TIMES[("newton_structured", case)] = (cuda_ms(kb), newton_bound(
                operands, s.nefc, s.nv, pb["act"], kw["iterations"], kw["ls_iterations"])["bound_ms"])
            print(f"kernel newton_structured: {case} {SHAPE_TIMES[('newton_structured', case)][0]:.4f} ms, "
                  f"bound {SHAPE_TIMES[('newton_structured', case)][1]:.4f} ms")
    results["newton_structured"]["max_abs_err"] = err


def check_newton_dense(device, results):
    """Kernel 5 against its plain version (and both against float64) on the
    operands of the paths that launch it, arm3 and cartpole at B=1024, and
    of the humanoid, which the JAX package sends to it and the port to
    kernel 4 (the two kernels must agree there); then on synthetic problems
    at nv = 1, 7, 25, 32 (257 envs), and at NEWTON_NVS as kernel 4's (4096
    envs): synthetic_dense_problem's own against float64
    (vs_float64), and eased (SYNTHETIC_EASED) against plain float32
    with the warmstart on and off and one env whose line search goes
    non-finite, where the first 257 envs and the first one alone must give
    the bits they give in the batch. Also the envs resident
    per SM at the paths' shapes: each path's batch in at most two waves.
    The JSON row's time and bound are arm3's (the larger of the two shapes
    its paths launch); cartpole and the humanoid are printed."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import dense_occupancy, newton_solve_dense, newton_solve_structured

    def dense(pa, **kw):
        pa = dict(pa)
        return newton_solve_dense(pa.pop("J"), pa.pop("qM"), pa.pop("aref"), pa.pop("D"), pa.pop("fl"),
                                  pa.pop("act"), pa.pop("a_s"), pa.pop("ws"), pa.pop("tol"), **pa, **kw)

    err, timed = 0.0, {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    # the humanoid stands in contact at its start; arm3 and cartpole reach
    # their contacts and limits within their paths' first 100 steps
    for name, steps in (("humanoid", 0), ("arm3", 100), ("cartpole", 100)):
        m = load_model(name, device=device)
        s = m.skel
        d = pre_solve(m, rollout(m, PATHS[name]["start"](m, 1024, device), steps))
        pa = dict(solver_operands(m, d, seed=4), ne=int(s.ne), nf=int(s.nf))
        kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
        envs = dense_occupancy(s.nv, s.nefc)
        print(f"{name} pre-solve: active efc rows per env {pa['act'].sum(1).mean().item():.2f} of {s.nefc}; "
              f"newton_dense holds {envs} envs per SM ({sms} SMs)")
        if name != "humanoid" and 2 * sms * envs < 1024:
            fail(f"newton_dense: {envs} envs per SM take more than two waves for {name}'s 1024 envs")
        got = dense(pa, **kw)
        err = max(err, newton_err(got, _newton_arrays(**pa, **kw), f"newton_dense {name}"))
        exact = _newton_arrays(**as_dtype(pa, torch.float64), **kw)
        newton_err(_newton_arrays(**pa, **kw), exact, f"newton_dense {name}, plain float32 vs float64")
        newton_err(got, exact, f"newton_dense {name}, kernel vs plain float64")
        timed[name] = dict(ms=cuda_ms(lambda: dense(pa, **kw)), plain_ms=plain_ms(lambda: _newton_arrays(**pa, **kw)),
                           **newton_bound([pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws")],
                                          s.nefc, s.nv, pa["act"], kw["iterations"], kw["ls_iterations"]))
        SHAPE_TIMES[("newton_dense", name)] = (timed[name]["ms"], timed[name]["bound_ms"])
        line = (f"kernel newton_dense: {name} B=1024 {timed[name]['ms']:.4f} ms, plain {timed[name]['plain_ms']:.4f} "
                f"ms, bound {timed[name]['bound_ms']:.4f} ms ({timed[name]['bound_by']})")
        if name == "humanoid":
            # the problem the JAX package sends to the dense kernel on the TPU
            # goes to kernel 4 here: the two kernels agree on it
            st = _pyramid_structure(s)

            def k4(pa=pa, d=d, st=st, kw=kw):
                return newton_solve_structured(pa["J"], d.efc_bJ, d.efc_dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"],
                                               pa["act"], pa["a_s"], pa["ws"], pa["tol"], st=st, **kw)

            newton_err(got, k4(), "newton_dense vs newton_structured humanoid")
            operands = [d.efc_bJ, d.efc_dsc] + [pa[k] for k in ("qM", "aref", "D", "fl", "act", "a_s", "ws")]
            SHAPE_TIMES[("newton_structured", "humanoid")] = (cuda_ms(k4), newton_bound(
                operands, s.nefc, s.nv, pa["act"], kw["iterations"], kw["ls_iterations"])["bound_ms"])
            line += (f" (the JAX package's route), newton_structured (the port's) on the same "
                     f"{SHAPE_TIMES[('newton_structured', 'humanoid')][0]:.4f} ms")
        print(line)

    syn = dict(iterations=5, ls_iterations=8, use_ws=True)
    for nv in (1, 7, 25, 32):
        pa = synthetic_dense_problem(257, nv, seed=5 + nv, device=device)
        err = max(err, newton_err(dense(pa, **syn), _newton_arrays(**pa, **syn), f"newton_dense synthetic nv={nv}"))
    bad = 5  # an env of the first 257, so every slice below holds it
    for nv in NEWTON_NVS:
        pa = synthetic_dense_problem(NUM_ENVS, nv, seed=80 + nv, device=device)
        vs_float64(dense(pa, **syn), _newton_arrays(**pa, **syn),
                   _newton_arrays(**as_dtype(pa, torch.float64), **syn), f"newton_dense synthetic nv={nv}")
        pa = synthetic_dense_problem(NUM_ENVS, nv, seed=5 + nv, device=device, **SYNTHETIC_EASED)
        nonfinite_row_line_search(pa, bad, pa["ne"])
        for use_ws in (True, False):
            kw = dict(syn, use_ws=use_ws)
            what = f"newton_dense eased synthetic nv={nv} ws={use_ws}"
            got, want = dense(pa, **kw), _newton_arrays(**pa, **kw)
            err = max(err, newton_err(got, want, what))
            if not kept_start(got, want, pa, bad, use_ws):
                fail(f"{what}: the env whose line search goes non-finite left its start")
            for b in (257, 1):
                if not all(torch.equal(x, y[:b]) for x, y in zip(dense(first_envs(pa, b), **kw), got)):
                    fail(f"{what}: the first {b} envs alone differ from the same envs in the whole batch")
        print(f"newton_dense eased synthetic nv={nv}: warmstart on and off match plain; the non-finite line search "
              f"keeps its start; B = 257 and 1 match B = {NUM_ENVS} bit for bit")
    print(f"kernel newton_dense: max |err| {err:.2e}")
    results["newton_dense"].update(max_abs_err=err, library_ms=None,
                                   **{k: timed["arm3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})


def elliptic_kern(pa, **kw):
    """Kernel 6 on the operands `pa` (solver_operands plus fr, impratio and
    the layout's ne, nf, base, ncon, cdim)."""
    from ambersim_tpu_torch.ops.newton import newton_solve_elliptic

    pa = dict(pa)
    return newton_solve_elliptic(
        pa.pop("J"), pa.pop("qM"), pa.pop("aref"), pa.pop("D"), pa.pop("fl"), pa.pop("act"), pa.pop("a_s"),
        pa.pop("ws"), pa.pop("tol"), pa.pop("fr"), pa.pop("impratio"), **pa, **kw,
    )


def elliptic_cost(pa, qacc):
    """Total cost per env at qacc, in float64."""
    import torch

    from ambersim_tpu_torch.engine.solver import cone_params, elliptic_total_cost

    p = as_dtype(pa, torch.float64)
    q = qacc.double()
    mu, scale = cone_params(p["fr"], p["impratio"], p["cdim"])
    jar = (p["J"] * q[:, None, :]).sum(-1) - p["aref"]
    return elliptic_total_cost(q, jar, p["qM"], p["a_s"], p["D"], p["fl"], p["act"], mu, scale, ne=p["ne"],
                               nf=p["nf"], nh=p["base"], S=p["ncon"], cdim=p["cdim"])


def elliptic_compare(pa, what, iterations, ls_iterations, use_ws=True, keep=False):
    """Kernel 6 vs plain float32 (and plain float32 vs float64) at the given
    iteration counts; returns (per-env relative error, max |err|, cost
    excess of the kernel over the plain version per env, the batch's mean
    cost excess); with `keep`, the outputs go to ELLIPTIC_RUNS."""
    import torch

    from ambersim_tpu_torch.engine.solver import _newton_arrays_elliptic

    kw = dict(iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws)
    got, want = elliptic_kern(pa, **kw), _newton_arrays_elliptic(**pa, **kw)
    exact = _newton_arrays_elliptic(**as_dtype(pa, torch.float64), **kw)
    rel, err = env_rel_err(got, want, what)
    rel_pe, _ = env_rel_err(want, exact, what)
    rel_ke, _ = env_rel_err(got, exact, what)
    c_got, c_want = elliptic_cost(pa, got[0]), elliptic_cost(pa, want[0])
    excess = (c_got - c_want) / c_want.abs().clamp(min=1.0)  # relative, absolute below a cost of 1
    print(f"{what} ({iterations} x {ls_iterations}): env-relative |kernel - plain| max {rel.max().item():.3e}, "
          f"share <= {ELLIPTIC_ENV_TOL}: kernel-plain {(rel <= ELLIPTIC_ENV_TOL).double().mean().item():.4f} "
          f"plain-f64 {(rel_pe <= ELLIPTIC_ENV_TOL).double().mean().item():.4f} "
          f"kernel-f64 {(rel_ke <= ELLIPTIC_ENV_TOL).double().mean().item():.4f}; "
          f"cost excess max {excess.max().item():.3e} min {excess.min().item():.3e}, "
          f"mean cost kernel/plain - 1 = {(c_got.mean() / c_want.mean() - 1).item():.3e}; max |err| {err:.3e}")
    if keep:
        ELLIPTIC_RUNS[what, iterations] = (got, want, exact, rel_pe)
    return rel, err, excess, (c_got.mean() / c_want.mean() - 1).item()


# the last elliptic_compare's (kernel, plain, float64 outputs, plain's
# per-env error against float64) by (what, iterations)
ELLIPTIC_RUNS: dict = {}


def elliptic_held(pa, what, use_ws=True, f64=True) -> float:
    """Kernel 6 at the ELLIPTIC_* bars: one line-search step elementwise,
    converged (CONVERGED) elementwise and by cost. With `f64`, a comparison
    where plain float32 misses its float64 run at that bar on more than
    1 - NEWTON_MIN_SHARE of the envs (as on the synthetic sweep of
    check_newton_elliptic) holds the kernel against float64 instead
    (vs_float64 with ELLIPTIC_F64_SLACK, converged with the
    ELLIPTIC_COST_ENVS count). Returns the max |err| where the bars are
    elementwise against the plain version (0 if none is)."""
    err = 0.0
    for (iterations, ls_iterations), tol in (((3, 1), ELLIPTIC_ENV_TOL),
                                              ((CONVERGED["iterations"], CONVERGED["ls_iterations"]),
                                               ELLIPTIC_CONVERGED_TOL)):
        rel, e, excess, _ = elliptic_compare(pa, what, iterations, ls_iterations, use_ws, keep=True)
        got, want, exact, rel_pe = ELLIPTIC_RUNS.pop((what, iterations))
        step = "one line-search step" if iterations == 3 else "converged"
        if not f64 or (rel_pe <= tol).double().mean().item() >= NEWTON_MIN_SHARE:
            share = (rel <= tol).double().mean().item()
            if share < NEWTON_MIN_SHARE or rel.max().item() > NEWTON_ENV_RTOL:
                fail(f"{what}, {step}: {share:.4f} of envs within {tol}, worst {rel.max().item():.3e}")
            if iterations > 3 and excess.max().item() > ELLIPTIC_COST_RTOL:
                fail(f"{what}, converged: the kernel's cost exceeds the plain version's by {excess.max().item():.3e}")
            err = max(err, e)
        else:
            vs_float64(got, want, exact, f"{what} ({step})",
                       within=lambda a, b: env_rel_err(a, b, what)[0] <= tol,
                       costs=tuple(elliptic_cost(pa, x[0]) for x in (got, want, exact)) if iterations > 3 else None,
                       slack=ELLIPTIC_F64_SLACK)
    return err


def check_newton_elliptic(device, results):
    """Kernel 6 against its plain version on the elliptic quadruped's
    operands at B=4096 and on synthetic problems at nv = 12 (nh = 0 and 9,
    cdim 3 and 6; 257 envs) at the ELLIPTIC_* bars, with a total-cost check;
    at NEWTON_NVS with cdim 2-6, nh = 0 and 9 and the warmstart on and off
    (4096 envs), where plain float32 itself misses float64 on more envs
    than those bars leave, against float64 (vs_float64 with
    ELLIPTIC_F64_SLACK and, converged, the ELLIPTIC_COST_ENVS count); at
    each nv one problem with an env whose line search goes non-finite, run
    with the warmstart on and off, where the first 37 envs and the first
    one alone must give the bits they give in the batch; its line-search
    step on non-finite Newton steps; and the envs resident per SM at the
    path's shapes: its 4096 envs in at most two waves."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine.solver import _newton_arrays_elliptic, elliptic_tail
    from ambersim_tpu_torch.ops.newton import elliptic_ls_step, elliptic_occupancy

    kern, cost, compare = elliptic_kern, elliptic_cost, elliptic_compare

    m = load_model("quadruped_elliptic", device=device)
    s = m.skel
    cdim, slots, base, full = elliptic_tail(s)
    d = initial_batch(m, NUM_ENVS, device)
    d = pre_solve(m, d.replace(ctrl=pd_ctrl(d)))
    pa = dict(solver_operands(m, d, seed=6), fr=d.contact.friction, impratio=m.opt.impratio, ne=int(s.ne),
              nf=int(s.nf), base=base, ncon=len(slots), cdim=cdim)
    it, ls = int(m.opt.iterations), int(m.opt.ls_iterations)
    envs = elliptic_occupancy(s.nv, s.nefc, len(slots), cdim)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"elliptic quadruped pre-solve: active efc rows per env {pa['act'].sum(1).mean().item():.1f} of {s.nefc}; "
          f"newton_elliptic holds {envs} envs per SM ({sms} SMs)")
    if 2 * sms * envs < NUM_ENVS:
        fail(f"newton_elliptic: {envs} envs per SM take more than two waves for {NUM_ENVS} envs")
    err = elliptic_held(pa, "newton_elliptic quadruped", f64=False)  # max |err| where the bars are elementwise
    _, _, _, mean_excess = compare(pa, "newton_elliptic quadruped", it, ls)
    if abs(mean_excess) > ELLIPTIC_MEAN_COST_RTOL:
        fail(f"newton_elliptic quadruped: mean cost differs from the plain version's by {mean_excess:.3e}")
    kw = dict(iterations=it, ls_iterations=ls, use_ws=True)
    ms, plain_t = cuda_ms(lambda: kern(pa, **kw)), plain_ms(lambda: _newton_arrays_elliptic(**pa, **kw))

    for nh, cd in ((0, 3), (9, 3), (0, 6), (9, 6)):
        sp = synthetic_elliptic_problem(257, nv=12, nh=nh, S=6, cdim=cd, seed=7 + nh + cd, device=device)
        err = max(err, elliptic_held(sp, f"newton_elliptic synthetic nh={nh} cdim={cd}", f64=False))
    bad = 5  # an env of the first 37, so every slice below holds it
    for nv in NEWTON_NVS:
        for cd in range(2, 7):
            nh = 9 if (nv + cd) % 2 else 0
            sp = synthetic_elliptic_problem(NUM_ENVS, nv=nv, nh=nh, S=6, cdim=cd, seed=7 + nv + nh + cd, device=device)
            for iterations, ls_iterations, tol in ((3, 1, ELLIPTIC_ENV_TOL),
                                                   (CONVERGED["iterations"], CONVERGED["ls_iterations"],
                                                    ELLIPTIC_CONVERGED_TOL)):
                kw = dict(iterations=iterations, ls_iterations=ls_iterations, use_ws=cd != 4)
                got, want = kern(sp, **kw), _newton_arrays_elliptic(**sp, **kw)
                exact = _newton_arrays_elliptic(**as_dtype(sp, torch.float64), **kw)
                what = (f"newton_elliptic synthetic nv={nv} nh={nh} cdim={cd} ws={cd != 4} "
                        f"({iterations} x {ls_iterations})")
                vs_float64(got, want, exact, what, within=lambda a, b: env_rel_err(a, b, what)[0] <= tol,
                           costs=tuple(cost(sp, x[0]) for x in (got, want, exact)) if iterations > 3 else None,
                           slack=ELLIPTIC_F64_SLACK)
        cd = 2 + nv % 5
        sp = synthetic_elliptic_problem(257, nv=nv, nh=9, S=6, cdim=cd, seed=90 + nv, device=device)
        nonfinite_row_line_search(sp, bad, sp["ne"])
        for use_ws in (True, False):
            kw = dict(iterations=it, ls_iterations=ls, use_ws=use_ws)
            what = f"newton_elliptic synthetic nv={nv} nh=9 cdim={cd} ws={use_ws} ({it} x {ls})"
            got = kern(sp, **kw)
            if not kept_start(got, _newton_arrays_elliptic(**sp, **kw), sp, bad, use_ws):
                fail(f"{what}: the env whose line search goes non-finite left its start")
            for b in (37, 1):
                if not all(torch.equal(x, y[:b]) for x, y in zip(kern(first_envs(sp, b), **kw), got)):
                    fail(f"{what}: the first {b} envs alone differ from the same envs in the whole batch")
        print(f"newton_elliptic synthetic nv={nv} cdim={cd}: the non-finite line search keeps its start with the "
              f"warmstart on and off; B = 37 and 1 match B = 257 bit for bit")

    # the line-search step selects, never blends, on a non-finite Newton step:
    # t - g/max(h, 1e-12) overflows to -inf / inf or is NaN, and the step
    # must return the bracket's midpoint
    state = torch.tensor([[0.5, 0.0, 4.0, 1e30, 0.0], [0.5, 0.0, 4.0, -1e30, 0.0],
                          [0.5, 0.0, 4.0, float("nan"), 1.0], [0.5, 0.0, 4.0, 1.0, float("inf")],
                          [0.5, 0.0, 4.0, -1.0, 1.0]], device=device)
    out = elliptic_ls_step(state).cpu().tolist()
    want = [[0.25, 0.0, 0.5], [2.25, 0.5, 4.0], [0.25, 0.0, 0.5], [0.25, 0.0, 0.5], [1.5, 0.5, 4.0]]
    print(f"newton_elliptic line-search step on non-finite Newton steps: {out}")
    if out != want:
        fail(f"newton_elliptic line-search step: got {out}, want {want}")

    print(f"kernel newton_elliptic: B={NUM_ENVS} {ms:.4f} ms, plain {plain_t:.4f} ms, max |err| {err:.2e}")
    operands = [pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "fr")]
    results["newton_elliptic"].update(max_abs_err=err, ms=ms, plain_ms=plain_t, library_ms=None,
                                      **newton_bound(operands, s.nefc, s.nv, pa["act"], it, ls))
    SHAPE_TIMES[("newton_elliptic", "elliptic quadruped")] = (ms, results["newton_elliptic"]["bound_ms"])


def initial_batch(m, batch: int, device):
    """make_data with qpos[7:] += 0.05 N(0, 1) drawn by numpy.random.default_rng(0)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    noise = np.random.default_rng(0).standard_normal((NUM_ENVS, m.nq - 7)).astype(np.float32)[:batch]
    qpos = d.qpos.clone()
    qpos[:, 7:] += torch.as_tensor(0.05 * noise, device=device)
    return d.replace(qpos=qpos)


def terrain_start(m, batch: int, device):
    """initial_batch moved onto the terrain's relief (onto_terrain)."""
    d = initial_batch(m, batch, device)
    return d.replace(qpos=onto_terrain(m, d.qpos))


def terrain_reset(env, generator, batch: int):
    """The terrain env's reset (its draw_start) moved onto the relief
    (onto_terrain)."""
    qpos, qvel = env.draw_start(generator, batch)
    return env.reset_to(onto_terrain(env.model, qpos), qvel)


def cartpole_start(m, batch: int, device):
    """qpos0 with qvel[:, 0] = 2 N(0, 1) from numpy.random.default_rng(0), so
    the slider's limit row becomes active."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    qvel = d.qvel.clone()
    qvel[:, 0] = torch.as_tensor(2.0 * np.random.default_rng(0).standard_normal(batch).astype(np.float32), device=device)
    return d.replace(qvel=qvel)


def arm3_start(m, batch: int, device):
    """qpos0 + 0.1 N(0, 1) from numpy.random.default_rng(0)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    noise = np.random.default_rng(0).standard_normal((batch, m.nq)).astype(np.float32)
    return d.replace(qpos=d.qpos + torch.as_tensor(0.1 * noise, device=device))


def rest_start(m, batch: int, device):
    from ambersim_tpu_torch.engine import make_data

    return make_data(m, batch)


def clutter_settled_start(m, batch: int, device):
    """The committed settled clutter state (CLUTTER_SETTLED: qpos, qvel) in
    every env."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    z = np.load(CLUTTER_SETTLED)
    return make_data(m, batch).replace(**{k: torch.as_tensor(z[k], device=device).expand(batch, -1).contiguous()
                                          for k in ("qpos", "qvel")})


def pd_ctrl(d):
    return KP * (0.0 - d.qpos[:, 7:]) - KD * d.qvel[:, 6:]


def quadruped_sensors_xml() -> str:
    """The main path's quadruped (read as text) with an `imu` site at the
    trunk's origin, a sphere site of radius 0.03 at each foot's centre, its
    12 motors made position servos (kp KP, kv KD, forcerange the motors'
    +-28: with ctrl at zero the actuator computes pd_ctrl, clamped as the
    motors clamp it) and 52 sensors: an IMU (framequat, gyro,
    accelerometer, velocimeter, framepos and framezaxis on `imu`), the
    trunk's subtreecom and subtreelinvel, jointpos, jointvel and
    actuatorfrc of the 12 joints and actuators, touch on the 4 foot sites,
    and per foot a netforce contact sensor of its foot and the floor."""
    xml = (REPO / QUADRUPED_XML).read_text()
    xml = xml.replace('<freejoint name="root"/>', '<freejoint name="root"/>\n      <site name="imu"/>')
    for f in FEET:
        foot = f'<geom name="{f}_foot" type="sphere" pos="0 0 -0.2" size="0.022" density="1100"/>'
        if foot not in xml:
            fail(f"quadruped_sensors_xml: no {f}_foot geom in {QUADRUPED_XML}")
        xml = xml.replace(foot, foot + f'\n            <site name="{f}_foot" type="sphere" pos="0 0 -0.2" size="0.03"/>')
    xml, n = re.subn(r'<motor name="(\w+)" joint="(\w+)" class="motor"/>',
                     rf'<position name="\1" joint="\2" kp="{KP:g}" kv="{KD:g}" forcerange="-28 28"/>', xml)
    if n != 12:
        fail(f"quadruped_sensors_xml: {n} motors made servos, not 12")
    joints = re.findall(r'<position name="\w+" joint="(\w+)"', xml)
    actuators = re.findall(r'<position name="(\w+)"', xml)
    rows = [f'<{t} objtype="site" objname="imu"/>' for t in ("framequat",)]
    rows += [f'<{t} site="imu"/>' for t in ("gyro", "accelerometer", "velocimeter")]
    rows += [f'<{t} objtype="site" objname="imu"/>' for t in ("framepos", "framezaxis")]
    rows += ['<subtreecom body="trunk"/>', '<subtreelinvel body="trunk"/>']
    rows += [f'<jointpos joint="{j}"/>' for j in joints] + [f'<jointvel joint="{j}"/>' for j in joints]
    rows += [f'<actuatorfrc actuator="{a}"/>' for a in actuators]
    rows += [f'<touch site="{f}_foot"/>' for f in FEET]
    rows += [f'<contact geom1="{f}_foot" geom2="floor" data="found force" reduce="netforce"/>' for f in FEET]
    sensors = "  <sensor>\n" + "".join(f"    {r}\n" for r in rows) + "  </sensor>\n"
    return xml.replace("</mujoco>", sensors + "</mujoco>")


def soft_feet_xml(cone: str | None = None) -> str:
    """The main path's quadruped (read as text) with condim="4" on its four
    foot geoms: each foot-floor pair takes condim 4, torsional friction
    0.02 from the default friction, every other pair condim 3 (nefc 144
    pyramidal: 24 head rows, 4 x 6 and 24 x 4 contact rows). `cone`
    ("elliptic") compiles it with elliptic cones: condims 3 and 4 mixed,
    no single contiguous condim tail."""
    xml = (REPO / QUADRUPED_XML).read_text()
    for f in FEET:
        foot = f'<geom name="{f}_foot" type="sphere"'
        if foot not in xml:
            fail(f"soft_feet_xml: no {f}_foot geom in {QUADRUPED_XML}")
        xml = xml.replace(foot, f'<geom name="{f}_foot" condim="4" type="sphere"')
    if cone:
        xml = _with_option(xml, f'cone="{cone}"')
    return xml


def condim6_xml() -> str:
    """The main path's quadruped (read as text) with condim="6" on the floor
    and elliptic cones: every pair takes condim 6 (torsional 0.02, rolling
    0.01 from the default friction), one contiguous cdim-6 tail (nefc 192)."""
    xml = (REPO / QUADRUPED_XML).read_text()
    floor = '<geom name="floor" type="plane"'
    if floor not in xml:
        fail(f"condim6_xml: no floor geom in {QUADRUPED_XML}")
    return _with_option(xml.replace(floor, '<geom name="floor" condim="6" type="plane"'), 'cone="elliptic"')


def quadruped_fluid_xml() -> str:
    """The main path's quadruped (read as text) in FLUID_MEDIUM under
    implicitfast, gravcomp="1" on the eight thigh and calf bodies, a
    trackcom camera (`follow`, 1.2 m behind the trunk's com looking
    forward and down, 640 x 480) and a targetbody light (`spot`, aimed at
    FL_calf) on the trunk, a site at each foot's centre and four
    CAMPROJECTION sensors of those sites in `follow`."""
    xml = _with_option((REPO / QUADRUPED_XML).read_text(), f'{FLUID_MEDIUM} integrator="implicitfast"')
    for f in FEET:
        for part in ("thigh", "calf"):
            tag = f'<body name="{f}_{part}" '
            if tag not in xml:
                fail(f"quadruped_fluid_xml: no {f}_{part} body in {QUADRUPED_XML}")
            xml = xml.replace(tag, tag + 'gravcomp="1" ')
        foot = f'<geom name="{f}_foot" type="sphere" pos="0 0 -0.2" size="0.022" density="1100"/>'
        if foot not in xml:
            fail(f"quadruped_fluid_xml: no {f}_foot geom in {QUADRUPED_XML}")
        xml = xml.replace(foot, foot + f'\n            <site name="{f}_foot" pos="0 0 -0.2"/>')
    xml = xml.replace('<freejoint name="root"/>', '<freejoint name="root"/>\n'
                      '      <camera name="follow" mode="trackcom" pos="0 -1.2 0.4" xyaxes="1 0 0 0 0.3 1" '
                      'resolution="640 480"/>\n'
                      '      <light name="spot" mode="targetbody" target="FL_calf" pos="0 0 1.5"/>')
    rows = "".join(f'    <camprojection site="{f}_foot" camera="follow"/>\n' for f in FEET)
    return xml.replace("</mujoco>", f"  <sensor>\n{rows}  </sensor>\n</mujoco>")


def _with_option(xml: str, attr: str) -> str:
    """`xml` with `attr` added to its <option> element."""
    if "<option " not in xml:
        fail(f"no <option> element to add {attr} to")
    return xml.replace("<option ", f"<option {attr} ", 1)


def tests_xml(file: str, name: str, folder: str = "tests") -> str:
    """The XML string constant `name` of `folder`/`file`, read as text (the
    JAX package's test modules and examples import JAX; this imports
    nothing of them)."""
    found = re.search(rf'^{name} = """(.*?)"""', (REPO / folder / file).read_text(), re.S | re.M)
    if not found:
        fail(f"no {name} in {folder}/{file}")
    return found.group(1)


def muscle_arm_xml() -> str:
    """examples/ex_muscle_tendon.py's ARM."""
    return tests_xml("ex_muscle_tendon.py", "ARM", folder="examples")


def tendon_rig_xml() -> str:
    """tests/test_tendon_parity.py's TENDON_RIG."""
    return tests_xml("test_tendon_parity.py", "TENDON_RIG")


def step_index(d, dt: float):
    """(B,) the index of the step each env of d is about to take (its time
    over the timestep, rounded), on d's device."""
    import torch

    return torch.round(d.time / dt)


def seeded_noise(seed: int, shape: tuple, batch: int, device):
    """N(0, 1) of numpy.random.default_rng(seed), (NUM_ENVS,) + shape drawn
    and the first `batch` kept (env b's the same at every batch)."""
    import numpy as np
    import torch

    noise = np.random.default_rng(seed).standard_normal((max(NUM_ENVS, batch),) + shape).astype(np.float32)
    return torch.as_tensor(noise[:batch], device=device)


def arm_start(m, batch: int, device):
    """qpos0 + 0.05 N(0, 1) (seeded_noise 17)."""
    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    return d.replace(qpos=d.qpos + 0.05 * seeded_noise(17, (m.nq,), batch, device))


# the biceps length (sensordata column 0, the forward before the step) each
# env carries into steps ARM_EXCITE[0] and ARM_EXCITE[1] of the latest arm
# rollout, recorded by arm_ctrl on the card
ARM_TRACE: dict = {}
TENDON_PATHS_DT = 0.002  # the ARM's and TENDON_RIG's <option timestep>


def arm_ctrl(d):
    """The example's excitation for the step each env is about to take
    (biceps ARM_BICEPS[0] on steps ARM_EXCITE, ARM_BICEPS[1] otherwise;
    shoulder ARM_SHOULDER), recording ARM_TRACE without a host sync."""
    import torch

    i = step_index(d, TENDON_PATHS_DT)
    length = d.sensordata[:, 0]
    for k in ARM_EXCITE:
        prev = ARM_TRACE.get(k)
        if prev is None or prev.shape != length.shape or prev.device != length.device:
            prev = torch.full_like(length, float("nan"))
        ARM_TRACE[k] = torch.where(i == k, length, prev)
    biceps = torch.where((i >= ARM_EXCITE[0]) & (i < ARM_EXCITE[1]), ARM_BICEPS[0], ARM_BICEPS[1])
    return torch.stack([biceps, torch.full_like(biceps, ARM_SHOULDER)], -1)


def tendon_rig_start(m, batch: int, device):
    """qpos 0.05 N(0, 1) about qpos0 = 0 (seeded_noise 18)."""
    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    return d.replace(qpos=d.qpos + 0.05 * seeded_noise(18, (m.nq,), batch, device))


def tendon_rig_ctrl(d):
    """tests/test_tendon_parity.py:146's ctrl at the step each env is about
    to take: (0.6 sin(0.01 i), 0.3 cos(0.013 i))."""
    import torch

    i = step_index(d, TENDON_PATHS_DT)
    return torch.stack([0.6 * torch.sin(0.01 * i), 0.3 * torch.cos(0.013 * i)], -1)


def mocap_rig_xml() -> str:
    """tests/test_mocap.py's MOCAP_WELD: a free box welded to a mocap sphere."""
    return tests_xml("test_mocap.py", "MOCAP_WELD")


def mocap_drag_xml() -> str:
    """MOCAP_WELD with a floor plane at z = DRAG_FLOOR, the worldbody's first
    child: the box starts resting on it."""
    return mocap_rig_xml().replace(
        "<worldbody>", f'<worldbody>\n  <geom name="floor" type="plane" size="0 0 1" pos="0 0 {DRAG_FLOOR:g}"/>', 1)


def refsite_arm_xml() -> str:
    """tests/test_refsite.py's ARM_XML."""
    return tests_xml("test_refsite.py", "ARM_XML")


def weld_start(m, batch: int, device):
    """qpos0, each env's mocap target WELD_TARGET + WELD_SPREAD N(0, I)
    (seeded_noise 23)."""
    import torch

    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    target = torch.tensor(WELD_TARGET, device=device) + WELD_SPREAD * seeded_noise(23, (3,), batch, device)
    return d.replace(mocap_pos=target[:, None, :])


def drag_start(m, batch: int, device):
    """qpos0 (the box resting on the floor), each env's mocap target
    (WELD_TARGET[:2] + WELD_SPREAD N(0, I), DRAG_Z) (seeded_noise 24)."""
    import torch

    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    xy = torch.tensor(WELD_TARGET[:2], device=device) + WELD_SPREAD * seeded_noise(24, (2,), batch, device)
    target = torch.cat([xy, torch.full_like(xy[:, :1], DRAG_Z)], -1)
    return d.replace(mocap_pos=target[:, None, :])


def refsite_start(m, batch: int, device):
    """qpos 0.1 N(0, 1) about qpos0 = 0 (seeded_noise 25), ctrl 0."""
    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    return d.replace(qpos=d.qpos + 0.1 * seeded_noise(25, (m.nq,), batch, device))


# the sensor rigs of the JAX package's tests and this script's actuator,
# distance and mocap fixtures: name -> (its XML, stepped SENSOR_RIG_STEPS
# steps card against CPU: the rigs with contacts or limit rows, the
# activations, the falling bodies; sensor_rigs)
SENSOR_RIGS = {
    "sensor_rig": (lambda: tests_xml("test_sensors.py", "SENSOR_RIG"), False),
    "contact_rig": (lambda: tests_xml("test_sensors.py", "CONTACT_RIG"), True),
    "box_rig": (lambda: tests_xml("test_contact_sensor.py", "BOX_RIG"), True),
    "subtree_rig": (lambda: tests_xml("test_contact_sensor.py", "SUBTREE_RIG"), True),
    "distance_rig": (lambda: DISTANCE_RIG, True),
    "ray_rig": (lambda: tests_xml("test_ray.py", "RAY_RIG"), False),
    "actuator_rig": (lambda: ACTUATOR_RIG, True),
    "mocap_rig": (mocap_rig_xml, True),
}


_XML_ARRAYS: dict = {}


def xml_model(xml: str, device, opt: dict | None = None):
    """The port's Model of an MJCF string on `device`, compiled here by the
    port's compiler with setconst (the numpy arrays cached by text), with
    `opt`'s Option overrides."""
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.io.bridge import model_from_numpy
    from ambersim_tpu_torch.mjcf import compile_spec_arrays, parse_mjcf_string

    if xml not in _XML_ARRAYS:
        skel_fields, leaves = compile_spec_arrays(parse_mjcf_string(xml))
        _XML_ARRAYS[xml] = skel_fields, set_constants(skel_fields, leaves)
    m = model_from_numpy(*_XML_ARRAYS[xml], device=device)
    return m.replace(opt=m.opt.replace(**opt)) if opt else m


def settled_start(name: str):
    """A path start: the first `batch` envs of path `name`'s final state
    (SETTLED), its qpos, qvel and warmstart."""
    def start(m, batch: int, device):
        from ambersim_tpu_torch.engine import make_data

        d = SETTLED[name]
        return make_data(m, batch).replace(**{k: getattr(d, k)[:batch].clone() for k in
                                              ("qpos", "qvel", "qacc_warmstart")})
    return start


_LINALG = ("cholesky", "cho_solve", "solve_pd")
_LINALG_BLOCK = ("cholesky_block", "cho_solve_block", "solve_pd_block")
# the clutter scene's launches per step: qM's factor, qacc_smooth's solve and
# one Hessian solve per Newton iteration (opt.iterations = 6), no Newton kernel
CLUTTER_PER_STEP = {"cholesky_block": 1, "cho_solve_block": 1, "solve_pd_block": 6}
# drop_scene's and the rock's: qM's factor, qacc_smooth's solve and kernel 4
# (no joint damping, so no Euler solve)
DROP_PER_STEP = {"cholesky": 1, "cho_solve": 1, "newton_structured": 1}
# the terrain quadruped's: those and the Euler damping solve (tendon_rig's too)
TERRAIN_PER_STEP = {"cholesky": 1, "cho_solve": 1, "solve_pd": 1, "newton_structured": 1}
# the muscle arm's: the dense Newton kernel in kernel 4's place
ARM_PER_STEP = {"cholesky": 1, "cho_solve": 1, "solve_pd": 1, "newton_dense": 1}
# the mocap weld's: qM's factor, qacc_smooth's solve and the dense Newton
# kernel (six equality rows, no contacts; no joint damping)
WELD_PER_STEP = {"cholesky": 1, "cho_solve": 1, "newton_dense": 1}
# soft_feet's: the dense Newton kernel (condim-4 blocks do not factor) and the Euler solve
SOFT_FEET_PER_STEP = {"cholesky": 1, "cho_solve": 1, "solve_pd": 1, "newton_dense": 1}
# soft_feet_elliptic's: no Newton kernel (the JAX package has none for mixed
# condims either); kernel 3 for each of the quadruped's 3 Newton iterations'
# Hessian solves and once for the Euler solve
SOFT_ELLIPTIC_PER_STEP = {"cholesky": 1, "cho_solve": 1, "solve_pd": 4}
CONDIM6_PER_STEP = {"cholesky": 1, "cho_solve": 1, "solve_pd": 1, "newton_elliptic": 1}
# implicitfast: kernel 3 is its (qM - h D) solve, in the Euler solve's place;
# implicit: an LU (torch.linalg.solve) there; RK4: four forwards and no solve
# (implicitfast at the quadruped's own 3 x 6 iterations is chaotic in the
# solver's decisions: the CPU's own rollout moves 3.5e-2 in qvel after 20
# steps under a 1e-6 nudge of its start, 1.9e-4 at CONVERGED; its card-vs-CPU
# check runs at CONVERGED)
IMPLICITFAST_PER_STEP = TERRAIN_PER_STEP
IMPLICIT_PER_STEP = DROP_PER_STEP
RK4_PER_STEP = {"cholesky": 4, "cho_solve": 4, "newton_structured": 4}
# quadruped_cg: qacc_smooth's solve, M^-1 g before the CG loop and once in
# each of its 3 iterations (kernel 2, five times), no Newton kernel;
# quadruped_noslip: the main path's launches and one more kernel 2 over the
# NOSLIP_RHS rows of J (M^-1 J^T, k = nefc right-hand sides per env)
CG_PER_STEP = {"cholesky": 1, "cho_solve": 5, "solve_pd": 1}
NOSLIP_PER_STEP = {"cholesky": 1, "cho_solve": 2, "solve_pd": 1, "newton_structured": 1}
# path -> its model (an asset, or `build`(device); and `opt` overrides),
# batch, steps, start, controller and the kernels every step launches (at
# least once each; exactly per_step where given). `floor` paths are held to
# FLOOR_TOL above the plane, `terrain` paths above the height field's
# surface (terrain_floor_gap), and both keep their final state in SETTLED,
# as `keep` paths do;
# `vs_cpu` says how 8 envs are held against the CPU (run_phases):
# "start" (default: 20 steps from the path's start at QPOS_TOL / QVEL_TOL),
# "settled" (20 steps from the final state at those bars), "spread" (5
# steps from it at 10 x the card's own spread, settled_card_vs_cpu),
# "sensors" (20 steps from the start, sensordata too: sensor_rollout),
# "converged" (as "start", both at CONVERGED solver options: the CPU's
# plain Newton arrays take ~1.5 s a step at the default 100 x 50) or
# "none" (a model another path holds)
PATHS = {
    "quadruped": dict(model="quadruped", envs=NUM_ENVS, steps=NUM_STEPS, start=initial_batch, ctrl=pd_ctrl,
                      kernels=_LINALG + ("newton_structured",), z=(0.20, 0.32), keep=True),
    "cartpole": dict(model="cartpole", envs=1024, steps=LADDER_STEPS, start=cartpole_start, ctrl=None,
                     kernels=_LINALG + ("newton_dense",)),
    "arm3": dict(model="arm3", envs=1024, steps=LADDER_STEPS, start=arm3_start, ctrl=None,
                 kernels=_LINALG + ("newton_dense",)),
    "quadruped_elliptic": dict(model="quadruped_elliptic", envs=NUM_ENVS, steps=ELLIPTIC_STEPS, start=initial_batch,
                               ctrl=pd_ctrl, kernels=_LINALG + ("newton_elliptic",), z=(0.20, 0.32)),
    "humanoid": dict(model="humanoid", envs=1024, steps=20, start=rest_start, ctrl=None,
                     kernels=_LINALG + ("newton_structured",)),
    "clutter32_rowcap192": dict(model="clutter32_rowcap192", envs=CLUTTER_ENVS, steps=CLUTTER_STEPS,
                                settle=CLUTTER_SETTLE, start=clutter_settled_start, ctrl=None, kernels=_LINALG_BLOCK,
                                per_step=CLUTTER_PER_STEP, floor=True, vs_cpu="spread"),
    "clutter32_cap48": dict(model="clutter32_cap48", envs=CLUTTER_ENVS, steps=CAP48_STEPS, settle=CLUTTER_SETTLE,
                            start=clutter_settled_start, ctrl=None, kernels=_LINALG_BLOCK, per_step=CLUTTER_PER_STEP,
                            floor=True, vs_cpu="none"),
    "drop_scene": dict(model="drop_scene", envs=DROP_ENVS, steps=DROP_STEPS, settle=DROP_SETTLE, start=rest_start,
                       ctrl=None, kernels=tuple(DROP_PER_STEP), per_step=DROP_PER_STEP, floor=True,
                       vs_cpu="settled"),
    "rock": dict(model="rock", envs=DROP_ENVS, steps=DROP_STEPS, settle=DROP_SETTLE, start=rest_start, ctrl=None,
                 kernels=tuple(DROP_PER_STEP), per_step=DROP_PER_STEP, floor=True, vs_cpu="settled"),
    "clutter32": dict(model="clutter32", envs=CLUTTER_ENVS, steps=EXACT_STEPS, settle=EXACT_SETTLE,
                      start=settled_start("clutter32_rowcap192"), ctrl=None, kernels=_LINALG_BLOCK,
                      per_step=CLUTTER_PER_STEP, floor=True, vs_cpu="spread"),
    "clutter32_rowcap192_bf16": dict(model="clutter32_rowcap192", opt=dict(hessian_bf16=True), envs=CLUTTER_ENVS,
                                     steps=BF16_STEPS, start=settled_start("clutter32_rowcap192"), ctrl=None,
                                     kernels=_LINALG_BLOCK, per_step=CLUTTER_PER_STEP, floor=True,
                                     vs_cpu="spread"),
    "quadruped_terrain": dict(build=lambda device: terrain_env(device).model, envs=NUM_ENVS, steps=NUM_STEPS,
                              start=terrain_start, ctrl=pd_ctrl, kernels=tuple(TERRAIN_PER_STEP),
                              per_step=TERRAIN_PER_STEP, z=(0.20, 0.32), terrain=True),
    "quadruped_sensors": dict(build=lambda device: xml_model(quadruped_sensors_xml(), device), envs=NUM_ENVS,
                              steps=NUM_STEPS, start=initial_batch, ctrl=None, kernels=tuple(TERRAIN_PER_STEP),
                              per_step=TERRAIN_PER_STEP, z=(0.20, 0.32), keep=True, vs_cpu="sensors"),
    "muscle_arm": dict(build=lambda device: xml_model(muscle_arm_xml(), device), envs=NUM_ENVS, steps=ARM_STEPS,
                       start=arm_start, ctrl=arm_ctrl, kernels=tuple(ARM_PER_STEP), per_step=ARM_PER_STEP, keep=True,
                       vs_cpu="converged"),
    "tendon_rig": dict(build=lambda device: xml_model(tendon_rig_xml(), device), envs=NUM_ENVS,
                       steps=TENDON_RIG_STEPS, start=tendon_rig_start, ctrl=tendon_rig_ctrl,
                       kernels=tuple(TERRAIN_PER_STEP), per_step=TERRAIN_PER_STEP, keep=True, vs_cpu="converged"),
    "mocap_weld": dict(build=lambda device: xml_model(mocap_rig_xml(), device), envs=NUM_ENVS, steps=WELD_STEPS,
                       start=weld_start, ctrl=None, kernels=tuple(WELD_PER_STEP), per_step=WELD_PER_STEP,
                       keep=True, vs_cpu="converged"),
    "mocap_drag": dict(build=lambda device: xml_model(mocap_drag_xml(), device), envs=NUM_ENVS, steps=WELD_STEPS,
                       start=drag_start, ctrl=None, kernels=tuple(DROP_PER_STEP), per_step=DROP_PER_STEP,
                       keep=True, vs_cpu="converged"),
    "refsite_arm": dict(build=lambda device: xml_model(refsite_arm_xml(), device), envs=NUM_ENVS,
                        steps=REFSITE_STEPS, start=refsite_start, ctrl=None, kernels=tuple(TERRAIN_PER_STEP),
                        per_step=TERRAIN_PER_STEP, keep=True, vs_cpu="converged"),
    "soft_feet": dict(build=lambda device: xml_model(soft_feet_xml(), device), envs=NUM_ENVS, steps=SOFT_FEET_STEPS,
                      start=initial_batch, ctrl=pd_ctrl, kernels=tuple(SOFT_FEET_PER_STEP),
                      per_step=SOFT_FEET_PER_STEP, z=(0.20, 0.32), keep=True),
    "soft_feet_elliptic": dict(build=lambda device: xml_model(soft_feet_xml("elliptic"), device), envs=NUM_ENVS,
                               steps=SOFT_ELLIPTIC_STEPS, start=initial_batch, ctrl=pd_ctrl,
                               kernels=tuple(SOFT_ELLIPTIC_PER_STEP), per_step=SOFT_ELLIPTIC_PER_STEP,
                               z=(0.20, 0.32), keep=True, vs_cpu="converged"),
    "condim6_elliptic": dict(build=lambda device: xml_model(condim6_xml(), device), envs=NUM_ENVS,
                             steps=CONDIM6_STEPS, start=initial_batch, ctrl=pd_ctrl, kernels=tuple(CONDIM6_PER_STEP),
                             per_step=CONDIM6_PER_STEP, z=(0.20, 0.32), keep=True, vs_cpu="converged"),
    "quadruped_implicitfast": dict(model="quadruped", opt=dict(integrator=IMPLICITFAST), envs=NUM_ENVS, steps=IMPLICITFAST_STEPS,
                                   start=initial_batch, ctrl=pd_ctrl, kernels=tuple(IMPLICITFAST_PER_STEP),
                                   per_step=IMPLICITFAST_PER_STEP, z=(0.20, 0.32), keep=True, vs_cpu="converged"),
    "quadruped_implicit": dict(model="quadruped", opt=dict(integrator=IMPLICIT), envs=NUM_ENVS, steps=IMPLICIT_STEPS,
                               start=initial_batch, ctrl=pd_ctrl, kernels=tuple(IMPLICIT_PER_STEP),
                               per_step=IMPLICIT_PER_STEP, z=(0.20, 0.32)),
    "quadruped_rk4": dict(model="quadruped", opt=dict(integrator=RK4), envs=NUM_ENVS, steps=RK4_STEPS,
                          start=initial_batch, ctrl=pd_ctrl, kernels=tuple(RK4_PER_STEP), per_step=RK4_PER_STEP,
                          z=(0.20, 0.32)),
    "quadruped_cg": dict(build=lambda device: cg_quadruped(device), envs=NUM_ENVS, steps=CG_STEPS, start=initial_batch,
                         ctrl=pd_ctrl, kernels=tuple(CG_PER_STEP), per_step=CG_PER_STEP, z=(0.20, 0.32), keep=True,
                         vs_cpu="converged"),
    "quadruped_noslip": dict(build=lambda device: xml_model(noslip_quadruped_xml(), device), envs=NUM_ENVS,
                             steps=NOSLIP_STEPS, start=initial_batch, ctrl=pd_ctrl, kernels=tuple(NOSLIP_PER_STEP),
                             per_step=NOSLIP_PER_STEP, z=(0.20, 0.32), keep=True, vs_cpu="converged"),
    "quadruped_fluid": dict(build=lambda device: xml_model(quadruped_fluid_xml(), device), envs=NUM_ENVS,
                            steps=FLUID_STEPS, start=initial_batch, ctrl=pd_ctrl, kernels=tuple(IMPLICITFAST_PER_STEP),
                            per_step=IMPLICITFAST_PER_STEP, z=(0.20, 0.32), keep=True, vs_cpu="settled"),
    "quadruped_dr": dict(model="quadruped", randomize="four", envs=NUM_ENVS, steps=DR_STEPS, start=initial_batch,
                         ctrl=pd_ctrl, kernels=tuple(TERRAIN_PER_STEP), per_step=TERRAIN_PER_STEP, z=(0.20, 0.32),
                         keep=True),
    "quadruped_dr_full": dict(model="quadruped", randomize="full", envs=NUM_ENVS, steps=DR_STEPS,
                              start=initial_batch, ctrl=pd_ctrl, kernels=tuple(TERRAIN_PER_STEP),
                              per_step=TERRAIN_PER_STEP, z=(0.20, 0.32), keep=True, vs_cpu="settled"),
}
# the floor, terrain and `keep` paths' final states (the card-vs-CPU
# checks, the starts of later paths, the sensor path's checks)
SETTLED: dict = {}
# path -> ms per step of its timed run in this call
STEP_MS: dict = {}
# Each launch-counting phase's shapes: the (batch, n) of kernels 1-3 and the
# case its Newton kernel is timed on (weighted_launch_time). PPO's eval
# launches (64 envs) are weighed at the training batch's shape.
PHASE_SHAPES = {
    "quadruped": ((NUM_ENVS, 18), "quadruped"), "cartpole": ((1024, 2), "cartpole"), "arm3": ((1024, 3), "arm3"),
    "quadruped_elliptic": ((NUM_ENVS, 18), "elliptic quadruped"), "humanoid": ((1024, 25), "humanoid"),
    "clutter32_rowcap192": ((CLUTTER_ENVS, 192), None), "clutter32_cap48": ((CLUTTER_ENVS, 192), None),
    "ppo_quadruped": ((NUM_ENVS, 18), "quadruped"), "ppo_pendulum": ((512, 1), None),
    "ppo_humanoid": ((1024, 25), "humanoid"),
    # the hand's solves and plants, each at its own batch (hand_mpc splits its launches)
    "hand_sampling": ((HAND_SAMPLES, 8), f"hand B={HAND_SAMPLES}"),
    "hand_mpc": ((HAND_SAMPLES, 8), f"hand B={HAND_SAMPLES}"), "hand_mpc_plant": ((1, 8), "hand B=1"),
    "hand_mpc_batch": ((HAND_MPC_BATCH * HAND_SAMPLES, 8), f"hand B={HAND_MPC_BATCH * HAND_SAMPLES}"),
    "hand_mpc_batch_plant": ((HAND_MPC_BATCH, 8), f"hand B={HAND_MPC_BATCH}"),
    "hand_contacts": ((HAND_CONTACT_ENVS, 8), "hand contacts"),
    "drop_scene": ((DROP_ENVS, 24), "drop_scene"), "rock": ((DROP_ENVS, 6), "rock"),
    "clutter32": ((CLUTTER_ENVS, 192), None), "clutter32_rowcap192_bf16": ((CLUTTER_ENVS, 192), None),
    "humanoid_sampling": ((HUMANOID_SAMPLES, 25), "humanoid sampling"),
    "pendulum_single": ((1, 1), None),
    # the gradient phases (grad_paths' at each path's own batch)
    "grad_pendulum": ((16, 1), None), "grad_arm3": ((16, 3), "arm3"), "grad_quadruped": ((64, 18), "quadruped"),
    "grad_quadruped_elliptic": ((8, 18), "elliptic quadruped"), "grad_hand": ((16, 8), "hand B=8"),
    "grad_clutter32_rowcap192": ((4, 192), None), "apg_pendulum": ((64, 1), None),
    "apg_quadruped": ((NUM_ENVS, 18), "quadruped"), "ilqr_pendulum": ((1, 1), None),
    "hand_gradient_trajopt": ((1, 8), "hand B=1"),
    # the model-I/O phases (grasp_scene's batch is set by grasp_memory)
    "compile_models": ((NUM_ENVS, 18), "quadruped"), "gripper_urdf": ((GRIPPER_ENVS, 8), "gripper"),
    # the height field's (kernel 4 at nefc 296, check_newton_ladder)
    "quadruped_terrain": ((NUM_ENVS, 18), "quadruped_terrain"), "ppo_terrain": ((NUM_ENVS, 18), "quadruped_terrain"),
    "quadruped_sensors": ((NUM_ENVS, 18), "quadruped"),
    # the tendon and muscle paths (their Newton cases: check_newton_tendon)
    "muscle_arm": ((NUM_ENVS, 2), "muscle_arm"), "tendon_rig": ((NUM_ENVS, 3), "tendon_rig"),
    "muscle_arm_sampling": ((ARM_SAMPLES, 2), f"muscle_arm B={ARM_SAMPLES}"),
    # the weld, drag and refsite paths (their Newton cases: check_newton_weld), and iLQR on the ball joint
    "mocap_weld": ((NUM_ENVS, 6), "mocap_weld"), "mocap_drag": ((NUM_ENVS, 6), "mocap_drag"),
    "refsite_arm": ((NUM_ENVS, 3), "refsite_arm"), "ilqr_ball": ((1, 3), None),
    # the condim and integrator paths (their Newton cases: check_newton_condim)
    "soft_feet": ((NUM_ENVS, 18), "soft_feet"), "soft_feet_elliptic": ((NUM_ENVS, 18), None),
    "condim6_elliptic": ((NUM_ENVS, 18), "condim6_elliptic"),
    "quadruped_implicitfast": ((NUM_ENVS, 18), "quadruped"), "quadruped_implicit": ((NUM_ENVS, 18), "quadruped"),
    "quadruped_rk4": ((NUM_ENVS, 18), "quadruped"),
    # CG and noslip; noslip's M^-1 J^T is kernel 2 at (batch, n, k right-hand sides), split off its phase
    "quadruped_cg": ((NUM_ENVS, 18), None), "quadruped_noslip": ((NUM_ENVS, 18), "quadruped"),
    "quadruped_noslip_rhs": ((NUM_ENVS, 18, NOSLIP_RHS), None),
    # fluid, gravcomp and cameras under implicitfast; per-env leaves, and PPO over them
    "quadruped_fluid": ((NUM_ENVS, 18), "quadruped"), "quadruped_dr": ((NUM_ENVS, 18), "quadruped"),
    "ppo_quadruped_dr": ((NUM_ENVS, 18), "quadruped"),
    # every per-env leaf; the batched iLQR (most launches in its line search's
    # 4 problems x 6 step sizes); the CG and noslip gradients (noslip's k =
    # 136 launch split off as for the path); the mesh hand's sampling (kernel
    # 5 timed on its own operands in hand_mesh_sampling)
    "quadruped_dr_full": ((NUM_ENVS, 18), "quadruped"),
    "ilqr_pendulum_batch": ((4 * 6, 1), None),
    "grad_quadruped_cg": ((16, 18), None), "grad_quadruped_noslip": ((16, 18), "quadruped"),
    "grad_quadruped_noslip_rhs": ((16, 18, NOSLIP_RHS), None),
    "hand_mesh_sampling": ((HAND_SAMPLES, 8), f"mesh hand B={HAND_SAMPLES}"),
}
# Section 9's phases, timed in section 9 (time_linalg_shapes) so that
# section 3 does the same work as before it; the evals' launches are
# weighed at the training batch's shape, the quadruped's Newton launches at
# the 4096-env case.
SECTION9_SHAPES = {
    "es_pendulum": ((ES_PENDULUM["population_size"], 1), None),
    "ars_pendulum": ((2 * ARS_PENDULUM["number_of_directions"], 1), None),
    "sac_pendulum": ((SAC_PENDULUM["num_envs"], 1), None),
    "es_quadruped": ((ES_QUADRUPED["population_size"], 18), "quadruped"), "sac_quadruped": ((128, 18), "quadruped"),
}
# (kernel, shape) -> (ms, bound_ms) measured in this run: the shape is
# (batch, n) for kernels 1-3 and a PHASE_SHAPES case for the Newton kernels
SHAPE_TIMES: dict = {}


def lowest_geom_point(m, d):
    """(B,) lowest z of every sphere, box, capsule and mesh geom at d's geom
    poses: a sphere's center less its radius, a box's lowest corner, a
    capsule's lower endpoint less its radius, a mesh's lowest hull vertex."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core.types import GeomType

    s = m.skel
    types = np.asarray(s.geom_type)
    low = []
    for t in (GeomType.SPHERE, GeomType.BOX, GeomType.CAPSULE, GeomType.MESH):
        ids = np.nonzero(types == int(t))[0]
        if not len(ids):
            continue
        idx = torch.as_tensor(ids, device=d.qpos.device)
        z, size, rz = d.geom_xpos[:, idx, 2], m.geom_size[idx], d.geom_xmat[:, idx, 2, :]  # rz: R's z row
        if t == GeomType.SPHERE:
            low.append((z - size[:, 0]).amin(1))
        elif t == GeomType.BOX:  # half-height sum_j |R[2, j]| size_j
            low.append((z - (rz.abs() * size).sum(-1)).amin(1))
        elif t == GeomType.CAPSULE:  # the axis is R's z column, its z component R[2, 2]
            low.append((z - size[:, 1] * rz[..., 2].abs() - size[:, 0]).amin(1))
        else:
            for g in ids:
                mid = int(s.geom_meshid[g])
                verts = m.mesh_vert[mid, : int(s.mesh_vertnum[mid])]  # (V, 3) in the geom frame
                low.append((d.geom_xpos[:, g, 2, None] + (d.geom_xmat[:, g, None, 2, :] * verts).sum(-1)).amin(1))
    return torch.stack(low, 1).amin(1)


def terrain_env(device):
    """quadruped_terrain at TERRAIN_CONFIG on `device` (its scene compiled
    by the port on this machine)."""
    from ambersim_tpu_torch.rl.quadruped import QuadrupedTerrainConfig, QuadrupedTerrainEnv

    return QuadrupedTerrainEnv(QuadrupedTerrainConfig(**TERRAIN_CONFIG), device=device)


def terrain_clearance(m, d, pts):
    """(B, k) the height of world points `pts` (B, k, 3) above the height
    field's surface at their own xy, in the field's frame; the surface is
    the grid's triangle there (cells split along the (j, i) -> (j + 1,
    i + 1) diagonal, as the narrowphase splits them)."""
    import numpy as np
    import torch

    s = m.skel
    gh = int(np.nonzero(np.asarray(s.geom_hfieldid) >= 0)[0][0])
    hid = int(s.geom_hfieldid[gh])
    R, p0 = d.geom_xmat[:, gh], d.geom_xpos[:, gh]
    local = ((pts - p0[:, None, :])[..., :, None] * R[:, None]).sum(-2)  # R^T (p - p0)
    size = m.hfield_size[hid]
    nrow, ncol = int(s.hfield_nrow[hid]), int(s.hfield_ncol[hid])
    z = m.hfield_data[hid, :nrow, :ncol] * size[2]
    fx = (local[..., 0] + size[0]) / (2 * size[0] / (ncol - 1))
    fy = (local[..., 1] + size[1]) / (2 * size[1] / (nrow - 1))
    i = torch.clamp(torch.floor(fx).long(), 0, ncol - 2)
    j = torch.clamp(torch.floor(fy).long(), 0, nrow - 2)
    u, v = fx - i, fy - j
    z00, z01, z10, z11 = z[j, i], z[j, i + 1], z[j + 1, i], z[j + 1, i + 1]
    h = torch.where(u >= v, z00 + u * (z01 - z00) + v * (z11 - z01), z00 + v * (z10 - z00) + u * (z11 - z10))
    return local[..., 2] - h


def terrain_floor_gap(m, d):
    """(B,) the least height above the height field's surface, at its own
    xy, of every sphere's lowest point (its center less its radius), each
    capsule endpoint's less its radius and each box corner
    (terrain_clearance)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core.types import GeomType
    from ambersim_tpu_torch.engine.collision import _BOX_CORNERS

    types, dev = np.asarray(m.skel.geom_type), d.qpos.device
    pts, drop = [], []  # world points (B, k, 3) and how far below each the surface is met (k,)
    for t in (GeomType.SPHERE, GeomType.CAPSULE, GeomType.BOX):
        ids = torch.as_tensor(np.nonzero(types == int(t))[0], device=dev)
        if not len(ids):
            continue
        xp, xm, size = d.geom_xpos[:, ids], d.geom_xmat[:, ids], m.geom_size[ids]
        if t == GeomType.SPHERE:
            pts.append(xp)
            drop.append(size[:, 0])
        elif t == GeomType.CAPSULE:
            for sign in (1.0, -1.0):
                pts.append(xp + sign * size[:, 1, None] * xm[..., :, 2])
                drop.append(size[:, 0])
        else:
            corners = torch.as_tensor(_BOX_CORNERS, device=dev) * size[:, None, :]  # (k, 8, 3)
            pts.append((xp[:, :, None, :] + (xm[:, :, None, :, :] * corners[None, :, :, None, :]).sum(-1)).flatten(1, 2))
            drop.append(torch.zeros(corners.shape[0] * 8, device=dev))
    return (terrain_clearance(m, d, torch.cat(pts, 1)) - torch.cat(drop)).amin(1)


def onto_terrain(m, qpos):
    """`qpos` (B, nq) moved to seeded xy over the field's relief, within
    TERRAIN_SPREAD m of the spawn (numpy.random.default_rng(15); env b's xy
    the same at every batch), and raised or lowered so that its lowest
    sphere, capsule or box point keeps the height above the terrain's
    surface it had at its own xy."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data, smooth

    B = qpos.shape[0]
    xy = np.random.default_rng(15).uniform(-TERRAIN_SPREAD, TERRAIN_SPREAD, (NUM_ENVS, 2)).astype(np.float32)[:B]
    moved = qpos.clone()
    moved[:, :2] += torch.as_tensor(xy, device=qpos.device)
    gap = [terrain_floor_gap(m, smooth.kinematics(m, make_data(m, B).replace(qpos=q))) for q in (qpos, moved)]
    moved[:, 2] += gap[0] - gap[1]
    return moved


def path_model(name: str, device, envs: int | None = None):
    """The model of path `name` on `device`, with the path's option
    overrides; a `randomize` path's per-env leaves drawn for its batch
    (randomize_quadruped, or randomize_quadruped_full for "full", from a CPU
    generator seeded DR_SEED, so both devices get the same leaves), cut to
    the first `envs` when given."""
    return path_model_leaves(name, device, envs)[0]


def path_model_leaves(name: str, device, envs: int | None = None):
    """(path_model, the names of the leaves its randomization function drew
    per env; () for a path without one)."""
    from ambersim_tpu_torch import load_model

    p = PATHS[name]
    m = p["build"](device) if "build" in p else load_model(p["model"], device=device)
    if p.get("opt"):
        m = m.replace(opt=m.opt.replace(**p["opt"]))
    if p.get("randomize"):
        import torch

        from ambersim_tpu_torch.core.types import env_slice
        from ambersim_tpu_torch.rl.quadruped import randomize_quadruped, randomize_quadruped_full

        fn = randomize_quadruped_full if p["randomize"] == "full" else randomize_quadruped
        m, names = fn(m, torch.Generator().manual_seed(DR_SEED), p["envs"])
        if envs is not None:
            m = env_slice(m, slice(0, envs))
        return m, tuple(names)
    return m, ()


def drive_path(name: str, device, card: str) -> dict:
    """Step one path through the port's entry points with the launch counts
    set to 0 just before and read just after; check its state. A path with
    `settle` steps settles first (uncounted, also its warm-up). Returns the
    path's launch counts."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    p = PATHS[name]
    m = path_model(name, device)
    d0 = p["start"](m, p["envs"], device)
    if p.get("settle"):
        t0 = time.perf_counter()
        d0 = rollout(m, d0, p["settle"], ctrl_fn=p["ctrl"])
        torch.cuda.synchronize()
        print(f"{name} path: settled {p['envs']} envs x {p['settle']} steps in {time.perf_counter() - t0:.3f} s",
              flush=True)
    else:
        rollout(m, d0, 3, ctrl_fn=p["ctrl"])  # warm-up
    active = torch.zeros((), device=device)

    def ctrl(d):
        # the rows of the step before (none before the first): summed on the card
        active.add_(d.efc_active.sum())
        return p["ctrl"](d) if p["ctrl"] else d.ctrl

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    d = rollout(m, d0, p["steps"], ctrl_fn=ctrl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    active = (active + d.efc_active.sum()).item() / (p["envs"] * p["steps"])
    for field in ("qpos", "qvel", "qacc", "efc_force"):
        if not torch.isfinite(getattr(d, field)).all():
            fail(f"{name} path: non-finite {field}")
    if "z" in p:
        # the trunk's height above the floor, or above the terrain's surface under it
        z, (lo, hi) = d.qpos[:, 2], p["z"]
        if p.get("terrain"):
            z = terrain_clearance(m, d, d.qpos[:, None, :3])[:, 0]
        what = "trunk height above the terrain's surface" if p.get("terrain") else "trunk z"
        if not bool(((z >= lo) & (z <= hi)).all()):
            fail(f"{name} path: {what} outside [{lo}, {hi}]: min {z.min().item():.4f} max {z.max().item():.4f}")
        print(f"{name} path: {what} in [{z.min().item():.4f}, {z.max().item():.4f}]")
    exactly = {k: n * p["steps"] for k, n in p["per_step"].items()} if "per_step" in p else None
    _check_launches(f"{name} path", launches, p["kernels"], p["steps"], exactly)
    if p.get("opt"):
        print(f"{name} path: model {p['model']} with {p['opt']}")
    if p.get("floor"):
        low = lowest_geom_point(m, d)
        force = d.efc_force.sum(1)
        if not (bool((low >= -FLOOR_TOL).all()) and bool(torch.isfinite(force).all())):
            fail(f"{name} path: a geom {-low.min().item():.4f} m below the floor or a non-finite contact force")
        print(f"{name} path: lowest geom point {low.min().item():.5f} m (>= -{FLOOR_TOL}); total contact force per "
              f"env mean {force.mean().item():.3f}; active contacts per env {d.efc_active.sum(1).float().mean().item() / 4:.1f}; "
              f"peak device memory over the timed steps {peak_gib:.2f} GiB, {peak_gib - held_gib:.2f} GiB above what "
              f"was held before them")
        SETTLED[name] = d
    if p.get("terrain"):
        gap = terrain_floor_gap(m, d)
        if not bool((gap >= -FLOOR_TOL).all()):
            fail(f"{name} path: a sphere, capsule or box point {-gap.min().item():.4f} m below the terrain's surface")
        print(f"{name} path: lowest sphere, capsule or box point above the terrain's surface {gap.min().item():.5f} m "
              f"(>= -{FLOOR_TOL}); active contacts per env {d.efc_active.sum(1).float().mean().item() / 4:.1f}; "
              f"peak device memory over the timed steps {peak_gib:.2f} GiB, {peak_gib - held_gib:.2f} GiB above "
              f"what was held before them")
        SETTLED[name] = d
    if p.get("keep"):
        SETTLED[name] = d
    STEP_MS[name] = 1e3 * seconds / p["steps"]
    rate = p["envs"] * p["steps"] / seconds
    print(
        f"{name} path: {p['envs']} envs x {p['steps']} steps in {seconds:.3f} s = {rate:.1f} env-steps/s, "
        f"{1e3 * seconds / p['steps']:.3f} ms per step [{card}]; active efc rows per env, mean over the steps "
        f"{active:.3f} of {m.skel.nefc}; launches {launches}",
        flush=True,
    )
    return launches


def card_vs_cpu(name: str, device, qpos_tol: float, qvel_tol: float, opt=None) -> None:
    """8 envs x 20 steps of a path on the card (kernels) and on the CPU
    (plain versions); `opt` overrides solver options on both."""
    from ambersim_tpu_torch.engine import rollout

    p = PATHS[name]
    runs = []
    for dev in (device, "cpu"):
        m = path_model(name, dev, envs=8)
        if opt:
            m = m.replace(opt=m.opt.replace(**opt))
        runs.append(rollout(m, p["start"](m, 8, dev), 20, ctrl_fn=p["ctrl"]))
    dq = (runs[0].qpos.cpu() - runs[1].qpos).abs().max().item()
    dv = (runs[0].qvel.cpu() - runs[1].qvel).abs().max().item()
    what = f"{name}{' ' + str(opt) if opt else ''}"
    print(f"{what} card vs cpu after 20 steps: max |dqpos| {dq:.3e} (<= {qpos_tol}), "
          f"max |dqvel| {dv:.3e} (<= {qvel_tol})")
    if not (dq <= qpos_tol and dv <= qvel_tol):
        fail(f"{what}: card rollout disagrees with the CPU rollout")


def stage_split(name: str, device, card: str, steps: int = 10) -> dict:
    """Wall time of each stage of a step of a settled path (host clock around
    a synchronize after each stage), median over `steps` steps; returns the
    medians by stage."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import collision, constraint, integrate, noslip, sensor, smooth, solver
    from ambersim_tpu_torch.engine.forward import forward

    m = path_model(name, device)
    # the model's integrator (RK4's three more forwards inside its stage)
    integrator = {RK4: ("rk4", lambda m, d: integrate.rk4(m, d, forward)), IMPLICIT: ("implicit", integrate.implicit),
                  IMPLICITFAST: ("implicitfast", integrate.implicitfast)}.get(int(m.opt.integrator),
                                                                              ("euler", integrate.euler))
    stages = (("fwd_position_smooth", smooth.fwd_position_smooth), ("collision", collision.collision),
              ("make_constraint", constraint.make_constraint), ("fwd_velocity", smooth.fwd_velocity),
              ("fwd_actuation", smooth.fwd_actuation), ("fwd_acceleration", smooth.fwd_acceleration),
              ("solve", solver.solve)) + ((("noslip", noslip.noslip),) if m.opt.noslip_iterations else ()) + (
                  (("sensors", sensor.sensors),) if m.skel.nsensor else ()) + (integrator,)
    times = {k: [] for k, _ in stages}
    d = SETTLED[name]
    for _ in range(steps):
        for k, fn in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = fn(m, d)
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t0))
    medians = {k: float(np.median(v)) for k, v in times.items()}
    split = ", ".join(f"{k} {v:.3f}" for k, v in medians.items())
    print(f"{name} stages, median ms of {steps} settled steps [{card}]: {split}", flush=True)
    return medians


def clutter_newton_spread(name: str, device) -> dict:
    """The clutter path's Newton solve (the large-nv route, kernel 3 inside)
    against the same batched solve in float64 with the plain factor, on
    fixed operands: CLUTTER_SETTLED broadcast to the path's 256 envs (the
    pre-solve on the card, a warmstart of qacc_smooth + 0.1 N(0, 1) per env
    from seed 8). Per env, max |route - float64| / (max |float64| + 1) over
    qacc, efc_force and qfrc_constraint must stay within the path's
    CLUTTER_SPREAD_BARS: the first on every env, the second at the median.
    Plain float32 is printed beside it. Returns the four spreads."""
    import numpy as np
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import linalg, make_data
    from ambersim_tpu_torch.engine.solver import _newton_arrays

    m = load_model(PATHS[name]["model"], device=device)
    s, B = m.skel, CLUTTER_ENVS
    z = np.load(CLUTTER_SETTLED)
    state = {k: torch.as_tensor(z[k], device=device).expand(B, -1).contiguous() for k in ("qpos", "qvel")}
    d = pre_solve(m, make_data(m, B).replace(**state))
    pa = dict(solver_operands(m, d, seed=8), ne=int(s.ne), nf=int(s.nf), iterations=int(m.opt.iterations),
              ls_iterations=int(m.opt.ls_iterations), use_ws=True)
    exact = _newton_arrays(**as_dtype(pa, torch.float64))
    rel, _ = env_rel_err(_newton_arrays(**pa, solve=linalg.solve_pd), exact, f"{name} newton route vs float64")
    rel_plain, _ = env_rel_err(_newton_arrays(**pa), exact, f"{name} newton plain float32 vs float64")
    out = dict(route_max=rel.max().item(), route_median=rel.median().item(), plain_max=rel_plain.max().item(),
               plain_median=rel_plain.median().item())
    bar_max, bar_median = CLUTTER_SPREAD_BARS[name]
    print(f"{name} newton solve on {B} envs of {CLUTTER_SETTLED.name} (nefc {s.nefc}): route (kernel 3) vs float64 "
          f"max {out['route_max']:.3e} median {out['route_median']:.3e} (bars {bar_max}, {bar_median}); plain "
          f"float32 vs float64 max {out['plain_max']:.3e} median {out['plain_median']:.3e} (env-relative)", flush=True)
    if not (out["route_max"] <= bar_max and out["route_median"] <= bar_median):
        fail(f"{name}: the large-nv Newton route is {out['route_max']:.3e} (median {out['route_median']:.3e}) "
             f"from float64")
    return out


def settled_card_vs_cpu(device, name: str) -> None:
    """8 envs of a path from its final state on the card, stepped on the
    card (kernels) and on the CPU (plain versions) under the path's
    controller, with the path's
    vs_cpu method: "settled", 20 steps at QPOS_TOL / QVEL_TOL; "spread",
    CLUTTER_CARD_VS_CPU_STEPS steps at bars from the card's own spread (the
    same steps from a start moved by 1e-6 in qpos: stacked contact-rich
    float32 scenes amplify rounding), 10 x spread + CLUTTER_QPOS_EPS in
    qpos and 10 x spread + CLUTTER_QVEL_EPS in qvel. Both print the spread."""
    import torch

    from ambersim_tpu_torch.engine import make_data, rollout

    settled = SETTLED[name]
    start = {k: getattr(settled, k)[:8].cpu() for k in ("qpos", "qvel", "qacc_warmstart")}
    spread = PATHS[name]["vs_cpu"] == "spread"
    k = CLUTTER_CARD_VS_CPU_STEPS if spread else 20

    def run(dev, nudge=0.0):
        m = path_model(name, dev, envs=8)
        fields = {f: v.to(dev) for f, v in start.items()}
        fields["qpos"] = fields["qpos"] + nudge
        return rollout(m, make_data(m, 8).replace(**fields), k, ctrl_fn=PATHS[name]["ctrl"])

    card, nudged, cpu = run(device), run(device, 1e-6), run("cpu")
    spread_q = (card.qpos - nudged.qpos).abs().max().item()
    spread_v = (card.qvel - nudged.qvel).abs().max().item()
    dq = (card.qpos.cpu() - cpu.qpos).abs().max().item()
    dv = (card.qvel.cpu() - cpu.qvel).abs().max().item()
    if spread:
        bar_q, bar_v = 10 * spread_q + CLUTTER_QPOS_EPS, 10 * spread_v + CLUTTER_QVEL_EPS
    else:
        bar_q, bar_v = QPOS_TOL, QVEL_TOL
    print(f"{name} card vs cpu, 8 settled envs x {k} steps: max |dqpos| {dq:.3e} (<= {bar_q:.3e}), max |dqvel| "
          f"{dv:.3e} (<= {bar_v:.3e}); the card's spread under a 1e-6 nudge: {spread_q:.3e} / {spread_v:.3e}")
    if not (dq <= bar_q and dv <= bar_v and torch.isfinite(card.qpos).all()):
        fail(f"{name}: card rollout disagrees with the CPU rollout")


def float64_copy(x):
    """A Model or Data (dataclasses of tensors) with every floating tensor
    in float64: the plain versions run in it on the CPU."""
    import dataclasses

    import torch

    kw = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            kw[f.name] = v.double()
        elif dataclasses.is_dataclass(v):
            kw[f.name] = float64_copy(v)
    return dataclasses.replace(x, **kw)


def data_head(d, n: int):
    """The first n envs of a batch-first Data (its contact set too)."""
    import dataclasses

    import torch

    kw = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v[:n]
        elif dataclasses.is_dataclass(v):
            kw[f.name] = data_head(v, n)
    return dataclasses.replace(d, **kw)


def sensor_columns(m) -> tuple:
    """(position, velocity, acceleration) stage masks over m's sensordata
    columns (numpy bool; the acceleration stage holds the force-derived
    rows and the contact sensor's)."""
    import numpy as np

    from ambersim_tpu_torch.core.types import SensorType
    from ambersim_tpu_torch.engine.sensor import ACC_STAGE, VEL_STAGE

    s = m.skel
    stage = np.zeros(s.nsensordata, np.int64)
    for t, a, n in zip(s.sensor_type, s.sensor_adr, s.sensor_dim):
        t = SensorType(int(t))
        stage[int(a): int(a + n)] = 2 if t in ACC_STAGE else 1 if t in VEL_STAGE else 0
    return stage == 0, stage == 1, stage == 2


def normal_atol(m, d):
    """(B, nsensordata) the atol a <normal> sensor's columns are held at by
    same_input_sensors, 0 elsewhere: the normal is the direction between
    two points dd apart (a sphere's or a capsule's core point and the other
    geom's closest point, dd = |dist + the core radii|), and float32
    rounding of their world coordinates turns it by up to NORMAL_ULPS / dd
    on either device."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core.types import GeomType, ObjType, SensorType
    from ambersim_tpu_torch.engine.collision import geom_pair_distance

    s = m.skel
    out = torch.zeros(d.qpos.shape[0], s.nsensordata, dtype=torch.float64)
    types, size = np.asarray(s.geom_type), m.geom_size[:, 0].cpu().numpy()
    core = np.where(np.isin(types, (int(GeomType.SPHERE), int(GeomType.CAPSULE))), size, 0.0)
    for i in np.nonzero(np.asarray(s.sensor_type) == int(SensorType.GEOMNORMAL))[0]:
        a, b = int(s.sensor_objid[i]), int(s.sensor_refid[i])
        if int(s.sensor_objtype[i]) == int(ObjType.GEOM):
            pairs = [(a, b)]
        else:  # two bodies' geoms
            pairs = [(x, y) for x in range(int(s.body_geomadr[a]), int(s.body_geomadr[a] + s.body_geomnum[a]))
                     for y in range(int(s.body_geomadr[b]), int(s.body_geomadr[b] + s.body_geomnum[b]))]
        g1, g2 = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
        dist = geom_pair_distance(m, d, g1, g2)[0].double()  # (B, P)
        k = dist.argmin(-1, keepdim=True)
        dd = (torch.take_along_dim(dist + torch.as_tensor(core[g1] + core[g2]), k, -1)).abs()
        adr = int(s.sensor_adr[i])
        out[:, adr:adr + 3] = NORMAL_ULPS / dd
    return out


def same_input_sensors(what: str, m_card, d_card, m_cpu) -> None:
    """sensor.sensors on the card and on the CPU from one Data, the first 8
    envs of d_card copied to the CPU: position and velocity rows within
    SENSOR_TOL, acceleration and force rows within SENSOR_FORCE_TOL (rtol,
    atol), every env; a <normal> sensor's at its conditioned bar where
    that is larger (normal_atol). Isolates the module from the solver's
    float32 spread."""
    import torch

    from ambersim_tpu_torch.engine import sensor

    d8 = data_head(d_card, 8).to("cpu")
    got = sensor.sensors(m_card, data_head(d_card, 8)).sensordata.cpu().double()
    want = sensor.sensors(m_cpu, d8).sensordata.double()
    cond = normal_atol(m_cpu, d8)
    pos, vel, acc = (torch.as_tensor(c) for c in sensor_columns(m_cpu))
    line = []
    for cols, (rtol, atol), rows in ((pos | vel, SENSOR_TOL, "position and velocity"),
                                     (acc, SENSOR_FORCE_TOL, "acceleration and force")):
        g, w = got[:, cols], want[:, cols]
        err = (g - w).abs()
        bar = torch.maximum(atol + rtol * w.abs(), cond[:, cols])
        line.append(f"{rows} rows ({int(cols.sum())} columns) max |d| {err.max().item() if err.numel() else 0.0:.3e} "
                    f"(rtol/atol {rtol}/{atol}, normals at NORMAL_ULPS / dd)")
        if not (bool(torch.isfinite(g).all()) and bool((err <= bar).all())):
            fail(f"{what}: sensors on the card and on the CPU from the same Data part: {line[-1]}")
    print(f"{what}: sensors card vs CPU on the same Data (8 envs, {m_cpu.skel.nsensor} sensors): " + "; ".join(line),
          flush=True)


def sensor_rollout(what: str, build, start, steps: int, device, ctrl_fn=None):
    """8 envs x `steps` steps of a sensor model on the card, on the CPU and,
    where it has acceleration or force rows, on the CPU in float64
    (float64_copy), each followed by a forward for the final state's
    sensordata. qpos, qvel and act, and the position and
    velocity rows, against the CPU at QPOS_TOL / QVEL_TOL; the acceleration
    and force rows as kernel 4's outputs are held: within NEWTON_TOL on
    NEWTON_MIN_SHARE of envs and NEWTON_ENV_RTOL of each env's largest
    (newton_err) where plain float32 meets float64 so, else against float64
    (vs_float64). Returns the card's final Data."""
    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.engine.forward import forward

    pos, vel, acc = sensor_columns(build("cpu"))
    runs = []
    # the float64 run only where there are acceleration and force rows to hold
    for dev, f64 in ((device, False), ("cpu", False)) + ((("cpu", True),) if acc.any() else ()):
        m = build(dev)
        d = start(m, 8, dev)
        if f64:
            m, d = float64_copy(m), float64_copy(d)
        runs.append(forward(m, rollout(m, d, steps, ctrl_fn=ctrl_fn)))
    card, cpu = runs[:2]

    def dmax(a, b):
        return (a.cpu() - b).abs().max().item() if a.numel() else 0.0

    diffs = dict(qpos=(dmax(card.qpos, cpu.qpos), QPOS_TOL), qvel=(dmax(card.qvel, cpu.qvel), QVEL_TOL),
                 act=(dmax(card.act, cpu.act), QPOS_TOL),
                 position_rows=(dmax(card.sensordata[:, pos], cpu.sensordata[:, pos]), QPOS_TOL),
                 velocity_rows=(dmax(card.sensordata[:, vel], cpu.sensordata[:, vel]), QVEL_TOL))
    print(f"{what} card vs cpu after {steps} steps, max |d|: "
          + ", ".join(f"{k} {v:.3e} (<= {bar})" for k, (v, bar) in diffs.items()), flush=True)
    if not all(v <= bar for v, bar in diffs.values()):
        fail(f"{what}: card rollout or its position / velocity sensor rows disagree with the CPU's")
    if acc.any():
        got, plain, f64 = (x.sensordata[:, acc].cpu() for x in runs)
        names = ("acceleration and force rows",)
        if newton_within((plain,), (f64,)).double().mean().item() >= NEWTON_MIN_SHARE:
            newton_err((got,), (plain,), f"{what} sensordata, card vs CPU", names)
            newton_err((plain,), (f64,), f"{what} sensordata, plain float32 vs float64", names)
        else:
            vs_float64((got,), (plain,), (f64,), f"{what} sensordata", names=names)
    return card


def rig_start(m, batch: int, device):
    """A sensor rig's start: make_data (at its first keyframe if it has
    one) with qpos + 0.01 N(0, 1), qvel 0.2 N(0, 1), ctrl 0.5 N(0, 1) and
    each mocap body moved by 0.1 N(0, 1) and turned to a random
    orientation, drawn by numpy.random.default_rng(16)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    s = m.skel
    d = make_data(m, batch, keyframe=0 if m.key_qpos.shape[0] else None)
    rng = np.random.default_rng(16)

    def draw(scale, *shape):
        return torch.as_tensor((scale * rng.standard_normal((batch,) + shape)).astype(np.float32), device=device)

    quat = draw(1.0, s.nmocap, 4)
    return d.replace(qpos=d.qpos + draw(0.01, s.nq), qvel=draw(0.2, s.nv), ctrl=draw(0.5, s.nu),
                     mocap_pos=d.mocap_pos + draw(0.1, s.nmocap, 3), mocap_quat=quat / quat.norm(dim=-1, keepdim=True))


def sensor_rigs(device) -> None:
    """Every SENSOR_RIGS model, card against CPU at 8 envs from rig_start:
    a rollout of SENSOR_RIG_STEPS steps at CONVERGED solver options
    (sensor_rollout) where the table says so, else a forward on the card;
    then that Data's sensors on both (same_input_sensors); a mocap body's
    frame is its mocap pose, bit for bit in position."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core import math as am
    from ambersim_tpu_torch.engine.forward import forward

    for name, (xml, roll) in SENSOR_RIGS.items():
        text = xml()
        m = xml_model(text, device, CONVERGED)
        if roll:
            card = sensor_rollout(name, lambda dev: xml_model(text, dev, CONVERGED), rig_start, SENSOR_RIG_STEPS,
                                  device)
        else:
            card = forward(m, rig_start(m, 8, device))
        if m.skel.nsensor:
            same_input_sensors(name, m, card, xml_model(text, "cpu", CONVERGED))
        if m.skel.nmocap:
            d = forward(m, rig_start(m, 8, device))
            body = torch.as_tensor(np.array(m.skel.mocap_bodyid), device=device)
            dpos = (d.xpos[:, body] - d.mocap_pos).abs().max().item()
            dquat = (d.xquat[:, body] - am.normalize_quat(d.mocap_quat)).abs().max().item()
            print(f"{name}: mocap bodies at their mocap poses: max |dpos| {dpos:.3e} (== 0), max |dquat| {dquat:.3e} "
                  f"(<= 1e-6)", flush=True)
            if not (dpos == 0.0 and dquat <= 1e-6):
                fail(f"{name}: a mocap body's frame is not its mocap pose")


def tendon_rigs_start(m, batch: int, device):
    """A tendon rig's start: qpos0 + 0.5 N(0, 1) (wraps on either branch,
    limits on either side), qvel 0.5 N(0, 1), ctrl and act uniform over
    [0, 1], drawn by numpy.random.default_rng(19)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    s = m.skel
    rng = np.random.default_rng(19)

    def draw(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    d = make_data(m, batch)
    return d.replace(qpos=d.qpos + draw(0.5 * rng.standard_normal((batch, s.nq))),
                     qvel=draw(0.5 * rng.standard_normal((batch, s.nv))), ctrl=draw(rng.uniform(0, 1, (batch, s.nu))),
                     act=draw(rng.uniform(0, 1, (batch, s.na))))


TENDON_FIELDS = ("ten_length", "ten_J", "ten_velocity", "actuator_length", "actuator_velocity")
TENDON_FORCE_FIELDS = ("qfrc_passive", "actuator_force", "qfrc_actuator", "act_dot")


def same_input_fields(what: str, m_card, d_card, m_cpu, groups) -> None:
    """A forward on the card and on the CPU from one Data (the first 8 envs
    of d_card): each group's Data fields (and "moment", the actuator moment
    matrix) within its (rtol, atol), every env."""
    from ambersim_tpu_torch.engine import forward
    from ambersim_tpu_torch.engine.smooth import actuator_moment

    got = forward(m_card, data_head(d_card, 8))
    want = forward(m_cpu, data_head(d_card, 8).to("cpu"))
    line = []
    for fields, (rtol, atol) in groups:
        for f in fields:
            if f == "moment":
                g, w = actuator_moment(m_card, got).cpu().double(), actuator_moment(m_cpu, want).double()
            else:
                g, w = getattr(got, f).cpu().double(), getattr(want, f).double()
            err = (g - w).abs()
            line.append(f"{f} {err.max().item() if err.numel() else 0.0:.3e}")
            if not (finite(g) and bool((err <= atol + rtol * w.abs()).all())):
                fail(f"{what}: {f} on the card and on the CPU from the same Data part: {line[-1]} "
                     f"(rtol/atol {rtol}/{atol})")
    bars = "; ".join(f"{tol} for {', '.join(fields)}" for fields, tol in groups)
    print(f"{what}: a forward card vs CPU on the same Data (8 envs), max |d|: {', '.join(line)} (rtol/atol {bars})",
          flush=True)


def same_input_tendons(what: str, m_card, d_card, m_cpu) -> None:
    """Tendon lengths, Jacobians and velocities and actuator lengths and
    velocities within SENSOR_TOL, passive and actuator forces and act_dot
    within SENSOR_FORCE_TOL (same_input_fields)."""
    same_input_fields(what, m_card, d_card, m_cpu, ((TENDON_FIELDS, SENSOR_TOL),
                                                    (TENDON_FORCE_FIELDS, SENSOR_FORCE_TOL)))


def finite(x) -> bool:
    import torch

    return bool(torch.isfinite(x).all())


def tendon_rigs(device) -> None:
    """Every TENDON_RIGS model, card against CPU at 8 envs from
    tendon_rigs_start: a rollout of SENSOR_RIG_STEPS steps at CONVERGED
    solver options (sensor_rollout: qpos, qvel, act and the sensor rows),
    then from the card's final Data a forward on both (same_input_tendons)
    and the sensors on both (same_input_sensors)."""
    for name, xml in TENDON_RIGS.items():
        text = xml()
        card = sensor_rollout(name, lambda dev: xml_model(text, dev, CONVERGED), tendon_rigs_start,
                              SENSOR_RIG_STEPS, device)
        m_card, m_cpu = xml_model(text, device, CONVERGED), xml_model(text, "cpu", CONVERGED)
        same_input_tendons(name, m_card, card, m_cpu)
        if m_cpu.skel.nsensor:
            same_input_sensors(name, m_card, card, m_cpu)


def muscle_arm_checks(device, card: str) -> None:
    """The muscle arm path's final state (SETTLED) and its trace: act finite
    and in [0, 1]; the biceps_len sensor equal to ten_length bit for bit;
    the tendon shortened under the excitation, every env's length at step
    ARM_EXCITE[1] below the tendon's rest length at qpos0 (tendon_length0:
    the example's start, the forearm held on its limit by gravity) and the
    mean below the mean at step ARM_EXCITE[0]. Per env, the length at
    ARM_EXCITE[1] is below the one at ARM_EXCITE[0] only where the env has
    come to rest before the excitation: a start flexed by the noise is
    still falling back at step ARM_EXCITE[0] (its share is printed)."""
    import torch

    m, d = path_model("muscle_arm", device), SETTLED["muscle_arm"]
    if not (finite(d.act) and bool(((d.act >= 0) & (d.act <= 1)).all())):
        fail(f"muscle_arm: act non-finite or outside [0, 1]: [{d.act.min().item()}, {d.act.max().item()}]")
    if not torch.equal(d.sensordata[:, 0], d.ten_length[:, 0]):
        fail("muscle_arm: the biceps_len sensor is not ten_length")
    start, end = (ARM_TRACE[k] for k in ARM_EXCITE)
    rest = m.tendon_length0[0]
    if not (finite(start) and finite(end)):
        fail(f"muscle_arm: no biceps length recorded at steps {ARM_EXCITE}")
    if not (bool((end < rest).all()) and end.mean().item() < start.mean().item()):
        fail(f"muscle_arm: the tendon did not shorten under the excitation: at step {ARM_EXCITE[1]} "
             f"[{end.min().item():.5f}, {end.max().item():.5f}] against its rest length {rest.item():.5f}, mean "
             f"{end.mean().item():.5f} against {start.mean().item():.5f} at step {ARM_EXCITE[0]}")
    print(f"muscle_arm: act in [{d.act.min().item():.4f}, {d.act.max().item():.4f}]; biceps_len == ten_length; "
          f"biceps length at step {ARM_EXCITE[1]} in [{end.min().item():.5f}, {end.max().item():.5f}] < its rest "
          f"length {rest.item():.5f} on every env, mean {end.mean().item():.5f} < {start.mean().item():.5f} at step "
          f"{ARM_EXCITE[0]}; shorter than at step {ARM_EXCITE[0]} on {(end < start).float().mean().item():.4f} "
          f"of the envs [{card}]", flush=True)


def arm_cost(device):
    """The example's StaticGoalQuadraticCost: Q 0.1 I, Qf 10 I, R 0.01 I,
    goal ARM_GOAL."""
    import torch

    from ambersim_tpu_torch.trajopt import StaticGoalQuadraticCost

    eye = torch.eye(len(ARM_GOAL), device=device)
    return StaticGoalQuadraticCost(Q=0.1 * eye, Qf=10.0 * eye, R=0.01 * torch.eye(2, device=device),
                                   xg=torch.tensor(ARM_GOAL, device=device))


def muscle_arm_sampling(device, card: str) -> dict:
    """The example's predictive sampling: ARM_OPTIMIZE_CALLS optimize calls
    of ARM_SAMPLES samples x ARM_KNOTS knots from x0 = 0, the launch counts
    set to 0 just before and read just after (each call: one forward and
    ARM_KNOTS steps, _per_call_launches). Checks: exact launches and finite
    results; then every call's chosen tape and the guess shot as one batch
    on the card and on the CPU (both at CONVERGED options, the CPU's plain
    Newton arrays being ~1.5 s a step at the default 100 x 50), within
    QPOS_TOL / QVEL_TOL, and on the card's shoot each chosen tape costing
    at most the guess (sample 0 of every call; a call none of whose 63
    draws does better returns it) and the best of them less. Returns the
    launch counts."""
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSampler, VanillaPredictiveSamplerParams, shoot

    m = xml_model(muscle_arm_xml(), device)
    nq, nx = m.skel.nq, m.skel.nq + m.skel.nv
    cost = arm_cost(device)
    sampler = VanillaPredictiveSampler(model=m, cost_function=cost, nsamples=ARM_SAMPLES, stdev=ARM_STDEV)
    x0 = torch.zeros(nx, device=device)
    guess = torch.full((ARM_KNOTS, m.skel.nu), ARM_GUESS, device=device)
    params = VanillaPredictiveSamplerParams(x0=x0, us_guess=guess, generator=torch.Generator().manual_seed(0))
    per_forward, per_step = _per_call_launches(m, device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    calls = [sampler.optimize(params) for _ in range(ARM_OPTIMIZE_CALLS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check_launches("muscle_arm_sampling", launches, tuple(k for k, n in per_step.items() if n), 1,
                    _expect(per_forward, per_step, ARM_OPTIMIZE_CALLS, ARM_OPTIMIZE_CALLS * ARM_KNOTS))
    for xs, us in calls:
        if not (finite(xs) and xs.shape == (ARM_KNOTS + 1, nx)):
            fail(f"muscle_arm_sampling: non-finite or misshapen xs_star {tuple(xs.shape)}")
    tapes = torch.stack([us for _, us in calls] + [guess])  # the chosen tapes, then the guess
    xs = shoot(xml_model(muscle_arm_xml(), device, CONVERGED), x0, tapes)
    xs_cpu = shoot(xml_model(muscle_arm_xml(), "cpu", CONVERGED), x0.cpu(), tapes.cpu())
    dq = (xs[..., :nq].cpu() - xs_cpu[..., :nq]).abs().max().item()
    dv = (xs[..., nq:].cpu() - xs_cpu[..., nq:]).abs().max().item()
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail(f"muscle_arm_sampling: the card's shoot of the chosen tapes differs from the CPU's by {dq:.3e} / {dv:.3e}")
    *costs, c_guess = cost.cost(xs, tapes).tolist()
    if not (all(c <= c_guess + 1e-5 + 1e-5 * abs(c_guess) for c in costs) and min(costs) < c_guess):
        fail(f"muscle_arm_sampling: the chosen tapes' costs {costs} against the guess's {c_guess:.4f}")
    print(f"muscle_arm_sampling: {ARM_OPTIMIZE_CALLS} optimize calls of {ARM_SAMPLES} samples x {ARM_KNOTS} knots in "
          f"{seconds:.3f} s, {1e3 * seconds / ARM_OPTIMIZE_CALLS:.3f} ms per call [{card}]; launches {launches}; "
          f"costs of the chosen tapes {', '.join(f'{c:.4f}' for c in costs)} against the guess's {c_guess:.4f}; final "
          f"elbow {calls[-1][0][-1, 1].item():+.4f} rad; the {len(tapes)} tapes' shoot card vs cpu over {ARM_KNOTS} "
          f"steps (CONVERGED): max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} (<= {QVEL_TOL})", flush=True)
    return launches


def check_newton_tendon(device, results) -> None:
    """The Newton kernels on the tendon paths' final states (SETTLED), with
    a warmstart of qacc_smooth + 0.1 N(0, 1): kernel 5 on the muscle arm's
    rows (two joint limits, the tendon's limit; 4096 envs), kernel 4 on
    TENDON_RIG's (its tendon equality, friction and limit rows and a
    contact; 4096 envs). Against the plain version at the NEWTON_* bars
    where plain float32 meets float64 on at least NEWTON_MIN_SHARE of the
    envs, else against float64 (vs_float64); each kernel's time beside its
    bound and its resident envs per SM, and kernel 5's at the sampler's
    batch (the first ARM_SAMPLES envs). Both models run the default 100 x
    50 Newton iterations: the plain version takes ~4 s a call there (host
    dispatch of every line-search step), so it is run once a dtype and
    not timed."""
    import torch

    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import (dense_occupancy, newton_solve_dense, newton_solve_structured,
                                               structured_occupancy)

    for name in ("muscle_arm", "tendon_rig"):
        m = path_model(name, device)
        s = m.skel
        st = _pyramid_structure(s)
        d = pre_solve(m, SETTLED[name])
        pa = solver_operands(m, d, seed=12)
        kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
        key = "newton_dense" if st is None else "newton_structured"

        def kern(b=NUM_ENVS, pa=pa, d=d, st=st, s=s):
            p = {k: v[:b] if k != "tol" else v for k, v in pa.items()}
            if st is None:
                return newton_solve_dense(p["J"], p["qM"], p["aref"], p["D"], p["fl"], p["act"], p["a_s"], p["ws"],
                                          p["tol"], ne=int(s.ne), nf=int(s.nf), **kw)
            return newton_solve_structured(p["J"], d.efc_bJ[:b], d.efc_dsc[:b], p["qM"], p["aref"], p["D"], p["fl"],
                                           p["act"], p["a_s"], p["ws"], p["tol"], st=st, **kw)

        def ref(dtype, pa=pa, s=s):
            return _newton_arrays(**as_dtype(pa, dtype), ne=int(s.ne), nf=int(s.nf), **kw)

        what = (f"{key} {name} (nefc {s.nefc}, nv {s.nv}"
                f"{f', nd_eq {st.nd_eq}, nd_ft {st.nd_ft}, {st.ncon3} contact' if st else ''})")
        got, plain, exact = kern(), ref(torch.float32), ref(torch.float64)
        share = newton_within(plain, exact).double().mean().item()
        print(f"{what}: active rows per env {pa['act'].sum(1).mean().item():.3f} of {s.nefc}; plain float32 meets "
              f"float64 on {share:.4f} of the envs")
        if share >= NEWTON_MIN_SHARE:
            err = newton_err(got, plain, what)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
            newton_err(plain, exact, f"{what}, plain float32 vs float64")
        else:
            vs_float64(got, plain, exact, what)
        envs = dense_occupancy(s.nv, s.nefc) if st is None else structured_occupancy(s.nv, s.nefc, st)
        for case, b in ((name, NUM_ENVS),) + (((f"{name} B={ARM_SAMPLES}", ARM_SAMPLES),) if st is None else ()):
            operands = ([d.efc_bJ[:b], d.efc_dsc[:b]] if st else [pa["J"][:b]]) + [
                pa[k][:b] for k in ("qM", "aref", "D", "fl", "act", "a_s", "ws")]
            bound = newton_bound(operands, s.nefc, s.nv, pa["act"][:b], kw["iterations"], kw["ls_iterations"])
            SHAPE_TIMES[(key, case)] = (cuda_ms(lambda b=b: kern(b)), bound["bound_ms"])
            print(f"kernel {key}: {name} B={b} {SHAPE_TIMES[(key, case)][0]:.4f} ms, bound {bound['bound_ms']:.4f} "
                  f"ms ({bound['bound_by']}); {envs} envs resident per SM", flush=True)


def weld_paths_checks(device, card: str) -> None:
    """The weld, drag and refsite paths' final states (SETTLED): every
    mocap_weld box within WELD_BAR of its target; every mocap_drag box
    within DRAG_BAR of its target, no geom DRAG_FLOOR_TOL under the floor, and
    the contact rows active on some envs (the share printed); each
    refsite_arm actuator's largest |actuator_length| below REFSITE_SHRINK
    of that at the start (a forward of refsite_start)."""
    import torch

    from ambersim_tpu_torch.engine import forward

    d = SETTLED["mocap_weld"]
    err = (d.qpos[:, :3] - d.mocap_pos[:, 0]).norm(dim=-1)
    if not (finite(err) and err.max().item() <= WELD_BAR):
        fail(f"mocap_weld: a box {err.max().item():.5f} m from its target (bar {WELD_BAR})")
    print(f"mocap_weld: box to target at step {WELD_STEPS}: max {err.max().item():.6f} m, mean "
          f"{err.mean().item():.6f} m (<= {WELD_BAR}) [{card}]", flush=True)

    m, d = path_model("mocap_drag", device), SETTLED["mocap_drag"]
    err = (d.qpos[:, :3] - d.mocap_pos[:, 0]).norm(dim=-1)
    low = lowest_geom_point(m, d) - DRAG_FLOOR
    ne = m.skel.ne
    touching = d.efc_active[:, ne:].any(1).float().mean().item()
    if not (finite(err) and err.max().item() <= DRAG_BAR and bool((low >= -DRAG_FLOOR_TOL).all()) and touching > 0):
        fail(f"mocap_drag: a box {err.max().item():.5f} m from its target (bar {DRAG_BAR}), a geom "
             f"{-low.min().item():.5f} m under the floor or no contact rows active ({touching:.4f} of the envs)")
    print(f"mocap_drag: box to target at step {WELD_STEPS}: max {err.max().item():.6f} m, mean "
          f"{err.mean().item():.6f} m (<= {DRAG_BAR}); lowest geom point {low.min().item():.5f} m from the floor "
          f"(>= -{DRAG_FLOOR_TOL}); contact rows active on {touching:.4f} of the envs [{card}]", flush=True)

    m = path_model("refsite_arm", device)
    with torch.no_grad():
        first = forward(m, refsite_start(m, NUM_ENVS, device)).actuator_length.abs().amax(0)
        last = forward(m, SETTLED["refsite_arm"]).actuator_length.abs().amax(0)
    if not (finite(last) and bool((last < REFSITE_SHRINK * first).all())):
        fail(f"refsite_arm: largest |actuator_length| {last.tolist()} at step {REFSITE_STEPS}, not below "
             f"{REFSITE_SHRINK:.4f} of {first.tolist()} at the start")
    print(f"refsite_arm: largest |actuator_length| per actuator {', '.join(f'{x:.4f}' for x in first.tolist())} at "
          f"the start -> {', '.join(f'{x:.4f}' for x in last.tolist())} at step {REFSITE_STEPS} (each below "
          f"{REFSITE_SHRINK:.4f} of its start) [{card}]", flush=True)


WELD_FIELDS = ("actuator_length", "actuator_velocity")
WELD_FORCE_FIELDS = ("actuator_force", "qfrc_actuator", "moment")
WELD_EFC_FIELDS = ("efc_J", "efc_pos", "efc_margin", "efc_D", "efc_active")


def same_input_rows(what: str, m_card, d_card, m_cpu) -> None:
    """Actuator lengths and velocities and the efc rows (J, pos, margin, D,
    active) within SENSOR_TOL, actuator forces, qfrc_actuator and the moment
    matrix within SENSOR_FORCE_TOL, efc_aref within AREF_ATOL
    (same_input_fields)."""
    same_input_fields(what, m_card, d_card, m_cpu, (
        (WELD_FIELDS + WELD_EFC_FIELDS, SENSOR_TOL), (WELD_FORCE_FIELDS, SENSOR_FORCE_TOL),
        (("efc_aref",), (SENSOR_TOL[0], AREF_ATOL))))


def weld_rigs(device) -> None:
    """Every WELD_RIGS model, card against CPU at 8 envs from rig_start: a
    rollout of SENSOR_RIG_STEPS steps at CONVERGED solver options
    (sensor_rollout: qpos, qvel and act), then from the card's final Data a
    forward on both (same_input_rows)."""
    for name, xml in WELD_RIGS.items():
        text = xml()
        card = sensor_rollout(name, lambda dev: xml_model(text, dev, CONVERGED), rig_start, SENSOR_RIG_STEPS, device)
        same_input_rows(name, xml_model(text, device, CONVERGED), card, xml_model(text, "cpu", CONVERGED))


def _ball_ilqr(m, device):
    """ILQR_BALL's problem on model `m`: (the optimizer, its params, the goal
    state)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.trajopt import ILQR, ILQRParams, state_diff

    c = ILQR_BALL
    goal = torch.tensor([np.cos(c["angle"]), 0.0, np.sin(c["angle"]), 0.0, 0.0, 0.0, 0.0], device=device)

    def running(x, u):
        return 0.01 * (u @ u)

    def terminal(x):
        z = state_diff(m, x[None], goal[None])[0]
        return 200.0 * (z @ z)

    x0 = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], device=device)
    params = ILQRParams(x0=x0, us_guess=torch.zeros(c["knots"], 3, device=device))
    return ILQR(model=m, running_cost=running, terminal_cost=terminal, iterations=c["iterations"]), params, goal


def ilqr_ball(device, card: str) -> dict:
    """tests/trajopt/test_ilqr.py:test_ilqr_ball_joint_manifold on the card
    (ILQR_BALL): exact launches (as ilqr_pendulum's), the cost at most the
    guess's and the final attitude error below ILQR_BALL_BAR; then the
    card's tape shot on the CPU: its states within QPOS_TOL / QVEL_TOL of
    the card's and its attitude error below the bar too. Returns the
    launches."""
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import shoot, state_diff

    c = ILQR_BALL
    xml = tests_xml("test_ilqr.py", "BALL_BODY", folder="tests/trajopt")
    m = xml_model(xml, device)
    opt, params, goal = _ball_ilqr(m, device)
    per_forward, per_step = _per_call_launches(m, device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xs, us = opt.optimize(params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    N, I = c["knots"], c["iterations"]
    _check_launches("ilqr_ball", launches, ("cholesky", "cho_solve", "solve_pd"), 1,
                    _expect(per_forward, per_step, 1, N + I * (1 + N)))
    with torch.no_grad():
        c_guess = opt._traj_cost(shoot(m, params.x0, params.us_guess), params.us_guess).item()
        m_cpu = xml_model(xml, "cpu")
        xs_cpu = shoot(m_cpu, params.x0.cpu(), us.cpu())
    c_star = opt._traj_cost(xs, us).item()
    err = state_diff(m, xs[-1:], goal[None])[0, :3].norm().item()
    err_cpu = state_diff(m_cpu, xs_cpu[-1:], goal.cpu()[None])[0, :3].norm().item()
    nq = m.skel.nq
    dq = (xs[:, :nq].cpu() - xs_cpu[:, :nq]).abs().max().item()
    dv = (xs[:, nq:].cpu() - xs_cpu[:, nq:]).abs().max().item()
    print(f"ilqr_ball: {N} knots x {I} iterations in {seconds:.3f} s = {1e3 * seconds / I:.1f} ms per iteration "
          f"[{card}]; cost {c_guess:.4f} -> {c_star:.6f}; attitude error {err:.3e} (bar {ILQR_BALL_BAR}); the tape "
          f"shot on the CPU: attitude error {err_cpu:.3e}, max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| "
          f"{dv:.3e} (<= {QVEL_TOL}); launches {launches}", flush=True)
    if not (finite(xs) and c_star <= c_guess and err < ILQR_BALL_BAR and err_cpu < ILQR_BALL_BAR
            and dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail(f"ilqr_ball: cost {c_star} (guess {c_guess}), attitude error {err} (the tape on the CPU {err_cpu}) or "
             f"the card's states {dq} / {dv} from the CPU's")
    return launches


def check_newton_weld(device, results) -> None:
    """The Newton kernels on the weld paths' final states (SETTLED), with a
    warmstart of qacc_smooth + 0.1 N(0, 1): kernel 5 on mocap_weld's six
    equality rows, kernel 4 on mocap_drag's (nd_eq 6, four condim-3
    contacts) and on refsite_arm's (nefc 4, nv 3: one condim-3 contact's
    four pyramid rows), 4096 envs each, at CONVERGED iterations (the plain version
    takes ~4 s a call at the paths' own 100 x 50, host dispatch of every
    line-search step); against the plain version at the NEWTON_* bars where
    plain float32 meets float64 on at least NEWTON_MIN_SHARE of the envs,
    else against float64 (vs_float64; the share printed). Each kernel is
    timed at its path's own iterations, beside its bound and its resident
    envs per SM."""
    import torch

    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import (dense_occupancy, newton_solve_dense, newton_solve_structured,
                                               structured_occupancy)

    for name in ("mocap_weld", "mocap_drag", "refsite_arm"):
        m = path_model(name, device)
        s = m.skel
        st = _pyramid_structure(s)
        d = pre_solve(m, SETTLED[name])
        pa = solver_operands(m, d, seed=13)
        own = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations))
        key = "newton_dense" if st is None else "newton_structured"

        def kern(its, pa=pa, d=d, st=st, s=s):
            if st is None:
                return newton_solve_dense(pa["J"], pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"],
                                          pa["ws"], pa["tol"], ne=int(s.ne), nf=int(s.nf), use_ws=True, **its)
            return newton_solve_structured(pa["J"], d.efc_bJ, d.efc_dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"],
                                           pa["act"], pa["a_s"], pa["ws"], pa["tol"], st=st, use_ws=True, **its)

        what = f"{key} {name} (nefc {s.nefc}, nv {s.nv}{f', nd_eq {st.nd_eq}, {st.ncon3} contacts' if st else ''})"
        plain, exact = (_newton_arrays(**as_dtype(pa, dt), ne=int(s.ne), nf=int(s.nf), use_ws=True, **CONVERGED)
                        for dt in (torch.float32, torch.float64))
        got = kern(CONVERGED)
        share = newton_within(plain, exact).double().mean().item()
        print(f"{what} at {CONVERGED}: active rows per env {pa['act'].sum(1).mean().item():.3f} of {s.nefc}; plain "
              f"float32 meets float64 on {share:.4f} of the envs")
        if share >= NEWTON_MIN_SHARE:
            err = newton_err(got, plain, what)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
            newton_err(plain, exact, f"{what}, plain float32 vs float64")
        else:
            vs_float64(got, plain, exact, what)
        envs = dense_occupancy(s.nv, s.nefc) if st is None else structured_occupancy(s.nv, s.nefc, st)
        operands = ([d.efc_bJ, d.efc_dsc] if st else [pa["J"]]) + [
            pa[k] for k in ("qM", "aref", "D", "fl", "act", "a_s", "ws")]
        bound = newton_bound(operands, s.nefc, s.nv, pa["act"], own["iterations"], own["ls_iterations"])
        SHAPE_TIMES[(key, name)] = (cuda_ms(lambda: kern(own)), bound["bound_ms"])
        print(f"kernel {key}: {name} B={NUM_ENVS} at {own} {SHAPE_TIMES[(key, name)][0]:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); {envs} envs resident per SM", flush=True)


def spin_pair_xml() -> str:
    """tests/test_elliptic.py's spin-down sphere: condim 4, elliptic cones,
    friction 0.8 0.2 0.01, 1 mm into the floor (its XML read as text)."""
    return tests_xml("test_elliptic.py", "XML").format(fr="0.8 0.2 0.01", condim=4, imp=1.0, z=0.0495)


def spin_start(m, batch: int, device):
    """The sphere at rest in the floor spinning at SPIN_QVEL about the normal,
    plus 0.5 N(0, 1) on every velocity (numpy.random.default_rng(19))."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    qvel = 0.5 * np.random.default_rng(19).standard_normal((batch, m.skel.nv)).astype(np.float32)
    qvel[:, 5] += SPIN_QVEL
    return make_data(m, batch).replace(qvel=torch.as_tensor(qvel, device=device))


def elliptic_operands(m, d, seed: int) -> dict:
    """Kernel 6's operands on a pre-solve Data of a model with one
    contiguous elliptic condim tail (solver_operands with its warmstart)."""
    from ambersim_tpu_torch.engine.solver import elliptic_tail

    s = m.skel
    cdim, slots, base, full = elliptic_tail(s)
    fr = d.contact.friction if full else d.contact.friction[:, slots]
    return dict(solver_operands(m, d, seed), fr=fr, impratio=m.opt.impratio, ne=int(s.ne), nf=int(s.nf), base=base,
                ncon=len(slots), cdim=cdim)


def check_solve_pd_operands(A, b, what: str, results) -> None:
    """Kernel 3 on a path's own systems A x = b (B, n, n), (B, n) against
    its plain version. An env is within when its largest |difference| is at
    most LINALG_TOL of its largest |component|: where plain float32 meets
    its float64 run so on at least NEWTON_MIN_SHARE of the envs, the kernel
    meets plain float32 so on as many, and no env by more than
    NEWTON_ENV_RTOL; else the kernel is held against float64 (vs_float64).
    Prints its time beside the plain version's and the bound."""
    import torch

    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.ops import linalg as kernels

    def within(x, y):
        return (x[0] - y[0]).abs().amax(1) <= LINALG_TOL * y[0].abs().amax(1)

    A, b = A.contiguous(), b.contiguous()
    got, want = (kernels.solve_pd_batched(A, b),), (plain.solve_pd_unrolled(A, b),)
    exact = (plain.solve_pd_unrolled(A.double(), b.double()),)
    if not torch.isfinite(got[0]).all():
        fail(f"{what}: non-finite kernel output")
    share = within(want, exact).double().mean().item()
    rel = (got[0] - want[0]).abs().amax(1) / want[0].abs().amax(1).clamp(min=1e-30)
    err = (got[0] - want[0]).abs().max().item()
    print(f"{what}: plain float32 meets float64 on {share:.4f} of the envs; kernel-plain share "
          f"{within(got, want).double().mean().item():.4f}, worst env {rel.max().item():.3e}, max |err| {err:.3e}")
    if share >= NEWTON_MIN_SHARE:
        if within(got, want).double().mean().item() < NEWTON_MIN_SHARE or rel.max().item() > NEWTON_ENV_RTOL:
            fail(f"{what}: the kernel misses the plain version")
        results["solve_pd"]["max_abs_err"] = max(results["solve_pd"]["max_abs_err"], err)
    else:
        vs_float64(got, want, exact, what, within=within, names=("x",))
    B, n = b.shape
    ms, plain_t = cuda_ms(lambda: kernels.solve_pd_batched(A, b)), plain_ms(lambda: plain.solve_pd_unrolled(A, b))
    bnd = linalg_bound("solve_pd", B, n)
    print(f"kernel solve_pd: {what} B={B} n={n} {ms:.4f} ms, plain {plain_t:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']})", flush=True)


def check_newton_condim(device, results) -> None:
    """The kernels on the condim and integrator paths' final states
    (SETTLED), with a warmstart of qacc_smooth + 0.1 N(0, 1) for the Newton
    kernels: kernel 5 on soft_feet's rows (nefc 144: condim-4 and condim-3
    pyramids) at the paths' own 3 x 6 iterations, against the plain version
    at the NEWTON_* bars where plain float32 meets float64 on at least
    NEWTON_MIN_SHARE of the envs, else against float64 (vs_float64); kernel
    6 on condim6_elliptic's (cdim 6, nefc 192) and on the spin-down sphere's
    (cdim 4, spin_start at NUM_ENVS envs) at the ELLIPTIC_* bars, or
    against float64 where plain float32 misses it (elliptic_held: one
    line-search step, converged and by cost; the quadruped's batch mean
    cost at its own 3 x 6 within ELLIPTIC_MEAN_COST_RTOL), with its shared
    memory a block and its resident envs per SM; kernel 3 on
    soft_feet_elliptic's last Newton Hessian (the general elliptic solve's
    third iteration) and on quadruped_implicitfast's (qM - h D) system
    (check_solve_pd_operands). Each kernel timed at its case; the host
    time of the general elliptic solve and of the implicit integrators'
    velocity derivatives."""
    import torch

    from ambersim_tpu_torch.engine import integrate, linalg, solver
    from ambersim_tpu_torch.engine.forward import forward
    from ambersim_tpu_torch.engine.solver import _newton_arrays, _newton_arrays_elliptic, _newton_elliptic_general
    from ambersim_tpu_torch.engine.solver import elliptic_blocks
    from ambersim_tpu_torch.ops._build import library
    from ambersim_tpu_torch.ops.newton import dense_occupancy, elliptic_occupancy, newton_solve_dense

    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def settled(name):
        m = path_model(name, device)
        d = SETTLED[name]
        return m, d.replace(ctrl=pd_ctrl(d))

    # ---- kernel 5 on soft_feet ----
    m, d = settled("soft_feet")
    s = m.skel
    d = pre_solve(m, d)
    pa = solver_operands(m, d, seed=19)
    kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)

    def kern5():
        return newton_solve_dense(pa["J"], pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"], pa["ws"],
                                  pa["tol"], ne=int(s.ne), nf=int(s.nf), **kw)

    def ref5(dtype=torch.float32):
        return _newton_arrays(**as_dtype(pa, dtype), ne=int(s.ne), nf=int(s.nf), **kw)

    what = f"newton_dense soft_feet (nefc {s.nefc}, nv {s.nv}, condim 4 feet)"
    got, plain, exact = kern5(), ref5(), ref5(torch.float64)
    share = newton_within(plain, exact).double().mean().item()
    print(f"{what}: active rows per env {pa['act'].sum(1).mean().item():.3f} of {s.nefc}; plain float32 meets "
          f"float64 on {share:.4f} of the envs")
    if share >= NEWTON_MIN_SHARE:
        err = newton_err(got, plain, what)
        results["newton_dense"]["max_abs_err"] = max(results["newton_dense"]["max_abs_err"], err)
        newton_err(plain, exact, f"{what}, plain float32 vs float64")
    else:
        vs_float64(got, plain, exact, what)
    envs = dense_occupancy(s.nv, s.nefc)
    operands = [pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws")]
    bnd = newton_bound(operands, s.nefc, s.nv, pa["act"], kw["iterations"], kw["ls_iterations"])
    SHAPE_TIMES[("newton_dense", "soft_feet")] = (cuda_ms(kern5), bnd["bound_ms"])
    # the J rows it keeps in shared memory at nefc 144 leave 12 envs an SM:
    # 2.59 waves of 4096 envs on 132 SMs, a finding for a redesign that
    # streams J (ROADMAP queue 2), printed rather than held to the two waves
    # the paths of earlier shapes are held to
    print(f"kernel newton_dense: soft_feet B={NUM_ENVS} {SHAPE_TIMES[('newton_dense', 'soft_feet')][0]:.4f} ms, plain "
          f"{plain_ms(ref5):.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); shared memory "
          f"{library().amb_newton_dense_smem_bytes(s.nv, s.nefc)} B a block; {envs} envs resident per SM "
          f"({sms} SMs): {NUM_ENVS / (sms * envs):.2f} waves", flush=True)

    # ---- kernel 6 on condim6_elliptic (cdim 6) and the spin-down sphere (cdim 4) ----
    m, d = settled("condim6_elliptic")
    spin = xml_model(spin_pair_xml(), device)
    for name, m, d in (("condim6_elliptic", m, pre_solve(m, d)),
                       ("spin-down sphere", spin, pre_solve(spin, spin_start(spin, NUM_ENVS, device)))):
        s = m.skel
        pa = elliptic_operands(m, d, seed=20)
        S, cdim = pa["ncon"], pa["cdim"]
        what = f"newton_elliptic {name} (cdim {cdim}, nefc {s.nefc}, nv {s.nv}, {S} contacts)"
        # at nefc 192 its rows in shared memory leave 8 envs an SM, 3.88
        # waves of 4096 envs on 132 SMs: printed, as kernel 5's above
        smem = library().amb_newton_elliptic_smem_bytes(s.nv, s.nefc, S, cdim)
        envs = elliptic_occupancy(s.nv, s.nefc, S, cdim)
        print(f"{what}: active efc rows per env {pa['act'].sum(1).mean().item():.1f}; shared memory {smem} B a "
              f"block; {envs} envs resident per SM ({sms} SMs): {NUM_ENVS / (sms * envs):.2f} waves")
        err = elliptic_held(pa, what)
        results["newton_elliptic"]["max_abs_err"] = max(results["newton_elliptic"]["max_abs_err"], err)
        it, ls = int(m.opt.iterations), int(m.opt.ls_iterations)
        if name == "condim6_elliptic":
            _, _, _, mean_excess = elliptic_compare(pa, what, it, ls)
            if abs(mean_excess) > ELLIPTIC_MEAN_COST_RTOL:
                fail(f"{what}: mean cost differs from the plain version's by {mean_excess:.3e}")
        kw = dict(iterations=it, ls_iterations=ls, use_ws=True)
        ms = cuda_ms(lambda: elliptic_kern(pa, **kw))
        # the sphere's plain version at its 30 x 30 is ~1.3 s of host
        # dispatch a call: one timed call after the warm one
        plain_t = (plain_ms if name == "condim6_elliptic" else lambda fn: cuda_ms(fn, reps=1, calls=1))(
            lambda: _newton_arrays_elliptic(**pa, **kw))
        operands = [pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "fr")]
        bnd = newton_bound(operands, s.nefc, s.nv, pa["act"], it, ls)
        if name == "condim6_elliptic":
            SHAPE_TIMES[("newton_elliptic", name)] = (ms, bnd["bound_ms"])
        print(f"kernel newton_elliptic: {name} B={NUM_ENVS} at {it} x {ls} {ms:.4f} ms, plain {plain_t:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)

    # ---- kernel 3 on the general elliptic solve's last Hessian and implicitfast's system ----
    m, d = settled("soft_feet_elliptic")
    s = m.skel
    d = pre_solve(m, d)
    systems = []

    def capture(H, g):
        systems.append((H, g))
        return linalg.solve_pd(H, g)

    tol = m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(), min=1.0)
    _newton_elliptic_general(d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, d.efc_active.float(),
                             d.qacc_smooth, d.qacc_warmstart, tol, *elliptic_blocks(s, d), m.opt.impratio,
                             ne=int(s.ne), nf=int(s.nf), iterations=int(m.opt.iterations),
                             ls_iterations=int(m.opt.ls_iterations), use_ws=True, solve=capture)
    check_solve_pd_operands(*systems[-1], f"soft_feet_elliptic Newton Hessian (iteration {len(systems)})", results)
    general = host_ms(lambda: solver.solve(m, d))
    m, d = settled("quadruped_implicitfast")
    d = forward(m, d)
    check_solve_pd_operands(*integrate.implicit_system(m, d, full=False), "quadruped_implicitfast (qM - h D)",
                            results)
    print(f"host ms, median of 5 synced calls at {NUM_ENVS} envs: the general elliptic solve on soft_feet_elliptic "
          f"{general:.3f}, the Coriolis derivative on the quadruped "
          f"{host_ms(lambda: integrate._coriolis_deriv(m, d)):.3f}, implicitfast's D "
          f"{host_ms(lambda: integrate._qderiv_vel(m, d)):.3f}", flush=True)


def cg_quadruped(device):
    """The main path's quadruped.xml loaded with solver="CG" through the
    port's own loader override (utils/io_utils.load_model_from_file)."""
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    return load_model_from_file(str(REPO / QUADRUPED_XML), solver="CG", device=device)


def noslip_quadruped_xml() -> str:
    """quadruped.xml with noslip_iterations="3" on its <option>."""
    return _with_option((REPO / QUADRUPED_XML).read_text(), 'noslip_iterations="3"')


def conditioned_solve_err(got, want, qM, what: str) -> float:
    """Kernel 2 against its plain version on a path's factor: per system,
    |got - want| <= LINALG_TOL (1 + |want|) + CONDITIONED_QACC cond(qM) u
    max |want| (the first-order rounding of the two sweeps on qM's factor,
    as conditioned_within widens qacc's bar). Returns max |got - want|."""
    import torch

    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    cond = torch.linalg.cond(qM.double())
    rows = (slice(None),) + (None,) * (w.dim() - 1)
    scale = w.abs().flatten(1).amax(1)[rows]
    bar = LINALG_TOL * (1.0 + w.abs()) + CONDITIONED_QACC * UNIT_ROUNDOFF_F32 * cond[rows] * scale
    err = (g - w).abs()
    if not bool((err <= bar).all()):
        fail(f"{what}: max |kernel - plain| {err.max().item():.3e} over the conditioned bar")
    print(f"{what}: max |kernel - plain| {err.max().item():.3e}, max cond(qM) {cond.max().item():.3e}", flush=True)
    return float(err.max().item())


def check_cho_solve_rhs(device, results) -> dict:
    """Kernel 2 with k right-hand sides per factor, (B, k, n), against its
    plain version at the noslip path's (NUM_ENVS, NOSLIP_RHS, 18) and at
    RHS_CASES (the warp design at n = 1 and 31, the block design at n = 33
    and 192 on 8 factors), each with the bits of k separate launches; the
    launcher refuses k = 0. Times at the noslip shape: the kernel, its
    plain version, torch.cholesky_solve on the same operands (one call, the
    k right-hand sides as columns) and the bound. Returns them."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(20)
    out = {}
    for B, n, k in ((NUM_ENVS, 18, NOSLIP_RHS),) + RHS_CASES:
        a, _ = random_spd(rng, B, n, device)
        l_ref = plain.cholesky_unrolled(a)
        rhs = torch.as_tensor(rng.standard_normal((B, k, n)).astype(np.float32), device=device)
        key, tol = ("cho_solve", LINALG_TOL) if n <= kernels.MAX_N_WARP else ("cho_solve_block", LARGE_LINALG_TOL)
        reset_launch_counts()
        got = kernels.cho_solve_batched(l_ref, rhs)
        if LAUNCHES[key] != 1:
            fail(f"{key} with k={k}: {LAUNCHES[key]} launches counted, want 1")
        err = max_err(got, plain.cho_solve_unrolled(l_ref, rhs), tol, tol, f"{key} B={B} n={n} k={k}")
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
        sep = torch.stack([kernels.cho_solve_batched(l_ref, rhs[:, j].contiguous()) for j in range(min(k, 8))], 1)
        max_err(got[:, :sep.shape[1]], sep, 0.0, 0.0, f"{key} B={B} n={n} k={k} vs separate launches")
        if (B, n, k) == (NUM_ENVS, 18, NOSLIP_RHS):
            out = dict(B=B, n=n, k=k, ms=cuda_ms(lambda: kernels.cho_solve_batched(l_ref, rhs)),
                       plain_ms=plain_ms(lambda: plain.cho_solve_unrolled(l_ref, rhs)),
                       library_ms=cuda_ms(lambda: torch.cholesky_solve(rhs.transpose(1, 2), l_ref)),
                       backward_ms=rhs_backward_ms(l_ref, rhs), max_abs_err=err,
                       **linalg_bound("cho_solve", B, n, k))
        print(f"{key} B={B} n={n} k={k}: within {err:.2e} of plain, the bits of separate launches", flush=True)
    try:
        kernels.cho_solve_batched(l_ref, torch.zeros(8, 0, 192, device=device))
    except ValueError:
        pass
    else:
        fail("cho_solve_batched took k = 0 right-hand sides")
    print(f"kernel cho_solve at the noslip shape B={out['B']} n={out['n']} k={out['k']}: {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, library (torch.cholesky_solve) {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}); its Function's backward {out['backward_ms']:.4f} ms",
          flush=True)
    print(json.dumps({"cho_solve_rhs": out}))
    return out


def rhs_backward_ms(l, rhs) -> float:
    """CUDA-event ms of kernel 2's Function's backward (autograd through the
    plain version on the card) at (B, k, n) right-hand sides, the noslip
    pass's M^-1 J^T under grad: a seeded linear functional's gradient with
    respect to the factor and the right-hand sides, the graph kept, as
    grad_kernels times the k = 1 rows. Fails unless the Function launched
    the kernel once and both gradients are finite."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import LAUNCHES

    leaves = [x.detach().clone().requires_grad_(True) for x in (l, rhs)]
    launched = LAUNCHES["cho_solve"]
    out = linalg.cho_solve_kernel(*leaves)
    if LAUNCHES["cho_solve"] != launched + 1:
        fail(f"cho_solve's Function at k={rhs.shape[1]} launched the kernel {LAUNCHES['cho_solve'] - launched} times")
    w = torch.as_tensor(np.random.default_rng(43).standard_normal(tuple(out.shape)).astype(np.float32), device=l.device)
    loss = (w * out).sum()
    if not all(torch.isfinite(g).all() for g in torch.autograd.grad(loss, leaves, retain_graph=True)):
        fail(f"cho_solve's Function at k={rhs.shape[1]}: a non-finite gradient")
    return cuda_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True), reps=2, calls=1)


def check_cg_noslip(device, card: str) -> None:
    """Kernel 2 on the CG and noslip paths' final states against its plain
    version (conditioned_solve_err): CG's M^-1 g at qacc_smooth, noslip's
    M^-1 J^T over every efc row (k = NOSLIP_RHS); the noslip sweep's updates
    and host ms (median of 5 synced calls of engine.noslip.noslip at
    NUM_ENVS envs, after the Newton solve), and CG's solve beside the
    Newton solve on the same state."""
    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.engine import noslip, solver
    from ambersim_tpu_torch.ops import linalg as kernels

    m = path_model("quadruped_cg", device)
    d = pre_solve(m, SETTLED["quadruped_cg"])
    jar = (d.efc_J * d.qacc_smooth[:, None, :]).sum(-1) - d.efc_aref
    g = -(d.efc_J * solver._row_costs(m, d, jar)[1][..., None]).sum(1)
    conditioned_solve_err(kernels.cho_solve_batched(d.qLD, g), plain.cho_solve_unrolled(d.qLD, g), d.qM,
                          "cho_solve on quadruped_cg's M^-1 g")
    cg_ms = host_ms(lambda: solver.solve(m, d))
    newton_ms = host_ms(lambda: solver.solve(m.replace(opt=m.opt.replace(solver=2)), d))
    m = path_model("quadruped_noslip", device)
    if m.skel.nefc != NOSLIP_RHS:
        fail(f"quadruped_noslip: nefc {m.skel.nefc}, NOSLIP_RHS {NOSLIP_RHS}")
    d = solver.solve(m, pre_solve(m, SETTLED["quadruped_noslip"]))
    J = d.efc_J.contiguous()
    conditioned_solve_err(kernels.cho_solve_batched(d.qLD, J), plain.cho_solve_unrolled(d.qLD, J), d.qM,
                          f"cho_solve on quadruped_noslip's M^-1 J^T (k = {NOSLIP_RHS})")
    plan = noslip.noslip_plan(m.skel, False)
    sweep_ms = host_ms(lambda: noslip.noslip(m, d))
    updates = plan.updates * int(m.opt.noslip_iterations)
    print(f"noslip on quadruped_noslip [{card}]: {plan.updates} updates a sweep ({len(plan.fl_rows)} frictionloss rows, "
          f"{len(plan.pairs)} pyramid axis pairs) x {int(m.opt.noslip_iterations)} sweeps = {updates} a step, host "
          f"{sweep_ms:.3f} ms a call ({sweep_ms / updates:.4f} ms an update); the CG solve {cg_ms:.3f} ms against "
          f"Newton's {newton_ms:.3f} ms on quadruped_cg's state, at {NUM_ENVS} envs", flush=True)


def solver_fixtures(device) -> None:
    """The slice's JAX-test fixtures, card against CPU at 8 envs:
    tests/test_noslip.py's scene at both cones and 1 and 3 noslip
    iterations (a forward from its test's start, the box pushed by 8 N and
    the hinge's motor at 0.5 + 0.1 N(0, 1), below its frictionloss; qacc
    and efc_force at QPOS_TOL, the hinge held: |qacc_hinge| < 1e-5 on the
    card);
    BALL_PLANE under CG at 20 x 20 iterations (20 steps at QPOS_TOL /
    QVEL_TOL);
    FWDINV on tests/test_flags.py's OVERRIDE_SCENE (solver_fwdinv within
    1e-4 + 1e-2 relative); inverse on tests/test_inverse.py's pendulum and
    ball under both cones and support on tests/test_support.py's rig
    (every function, every body, at 1e-5 + 1e-5 relative). The noslip
    scene at NOSLIP_SCENE_OPT and its test's 8 N push: at pushes of
    8 + 0.5 N(0, 1) N some envs' noslip results move by up to 0.14 in qacc
    under a 1e-6 nudge of qpos on the CPU alone (card vs CPU 1.1e-1 on
    one); at 8 N by < 3e-5 under a 1e-6 N change of the push, at 30 x 30
    as at the scene's own 100 x 50 (at 15 x 15 the elliptic scene's by
    3.1e-3)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import forward, inverse, make_data, rollout, support

    rng = np.random.default_rng(21)

    def both(xml, opt=None):
        return xml_model(xml, device, opt), xml_model(xml, "cpu", opt)

    def close(what, got, want, rtol, atol):
        err = (got.cpu() - want).abs()
        if not bool((err <= atol + rtol * want.abs()).all()):
            fail(f"{what}: card vs CPU {err.max().item():.3e}")
        return err.max().item()

    worst = {}
    for ni in (1, 3):
        for cone in ("pyramidal", "elliptic"):
            mc, mp = both(NOSLIP_SCENE().replace("{NI}", str(ni)).replace("{CONE}", cone), NOSLIP_SCENE_OPT)
            d = make_data(mp, 8)
            xfrc = d.xfrc_applied.clone()
            xfrc[:, 1, 0] = 8.0
            d = d.replace(xfrc_applied=xfrc, ctrl=torch.as_tensor(0.5 + 0.1 * rng.standard_normal((8, 1)),
                                                                  dtype=torch.float32))
            got, want = forward(mc, d.to(device)), forward(mp, d)
            what = f"noslip scene NI {ni} {cone}"
            worst[what] = max(close(f"{what} qacc", got.qacc, want.qacc, QPOS_TOL, QPOS_TOL),
                              close(f"{what} efc_force", got.efc_force, want.efc_force, QPOS_TOL, QPOS_TOL))
            if not float(got.qacc[:, 6].abs().max()) < 1e-5:
                fail(f"{what}: the hinge moves on the card, |qacc| {got.qacc[:, 6].abs().max().item():.3e}")
    mc, mp = both(BALL_PLANE(), dict(solver=1, iterations=20, ls_iterations=20))
    d = make_data(mp, 8)
    qpos = d.qpos.clone()
    qpos[:, 2] = 0.099
    d = d.replace(qpos=qpos, qvel=torch.as_tensor(0.5 * rng.standard_normal((8, 6)), dtype=torch.float32))
    got, want = rollout(mc, d.to(device), 20), rollout(mp, d, 20)
    worst["ball_plane CG qpos"] = close("ball_plane CG qpos", got.qpos, want.qpos, 0.0, QPOS_TOL)
    worst["ball_plane CG qvel"] = close("ball_plane CG qvel", got.qvel, want.qvel, 0.0, QVEL_TOL)
    mc, mp = both(tests_xml("test_flags.py", "OVERRIDE_SCENE").format(flag='fwdinv="enable"'))
    d = make_data(mp, 8)
    d = d.replace(qvel=torch.as_tensor(0.2 * rng.standard_normal((8, 6)), dtype=torch.float32))
    got, want = forward(mc, d.to(device)), forward(mp, d)
    worst["fwdinv"] = close("override scene solver_fwdinv", got.solver_fwdinv, want.solver_fwdinv, 1e-2, 1e-4)
    inv_xml = tests_xml("test_inverse.py", "BALL_ON_PLANE")
    for name, xml in (("pendulum", tests_xml("test_inverse.py", "PENDULUM")),
                      ("ball_pyramidal", inv_xml.replace("{cone}", "pyramidal")),
                      ("ball_elliptic", inv_xml.replace("{cone}", "elliptic"))):
        mc, mp = both(xml)
        d = make_data(mp, 8)
        d = d.replace(qvel=torch.as_tensor(0.3 * rng.standard_normal(d.qvel.shape), dtype=torch.float32),
                      qacc=torch.as_tensor(rng.standard_normal(d.qacc.shape), dtype=torch.float32))
        got, want = inverse(mc, d.to(device)), inverse(mp, d)
        worst[f"inverse {name}"] = max(close(f"inverse {name} {f}", getattr(got, f), getattr(want, f), 1e-4, 1e-4)
                                       for f in ("qfrc_inverse", "qfrc_constraint", "efc_force"))
    mc, mp = both(tests_xml("test_support.py", "RIG"))
    d = make_data(mp, 8)
    d = forward(mp, d.replace(qvel=torch.as_tensor(0.3 * rng.standard_normal(d.qvel.shape), dtype=torch.float32)))
    dc = d.to(device)
    point = torch.as_tensor(rng.standard_normal((8, 3)), dtype=torch.float32)
    err = 0.0
    for b in range(1, mp.skel.nbody):
        for fn, args in ((support.jac, (point, b)), (support.jac_body, (b,)), (support.jac_body_com, (b,)),
                         (support.apply_ft, (point, point, point, b))):
            g, w = fn(mc, dc, *[a.to(device) if isinstance(a, torch.Tensor) else a for a in args]), fn(mp, d, *args)
            for gi, wi in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
                err = max(err, close(f"support {fn.__name__} body {b}", gi, wi, 1e-5, 1e-5))
    for i in range(mp.skel.nsite):
        for gi, wi in zip(support.jac_site(mc, dc, i), support.jac_site(mp, d, i)):
            err = max(err, close(f"support jac_site {i}", gi, wi, 1e-5, 1e-5))
    vec = torch.as_tensor(rng.standard_normal((8, mp.skel.nv)), dtype=torch.float32)
    err = max(err, close("support mul_m", support.mul_m(mc, dc, vec.to(device)), support.mul_m(mp, d, vec), 1e-5,
                         1e-5))
    worst["support"] = err
    print("slice fixtures card vs CPU, max |card - cpu|: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()),
          flush=True)


def host_ms(fn, calls: int = 5) -> float:
    """Median wall ms of `calls` calls of fn, each ended by a synchronize."""
    import numpy as np
    import torch

    times = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times[1:]))


def sensor_cols(m, stype) -> list:
    """The sensordata columns of every sensor of type `stype`, in order."""
    s = m.skel
    return [c for t, a, n in zip(s.sensor_type, s.sensor_adr, s.sensor_dim) if int(t) == int(stype)
            for c in range(int(a), int(a + n))]


def quadruped_sensors_checks(device, card: str) -> None:
    """The sensor path's final state (a forward there): jointpos, jointvel,
    actuatorfrc and subtreecom equal to qpos[:, 7:], qvel[:, 6:],
    actuator_force and subtree_com[:, 1] bit for bit, framequat the trunk's
    xquat up to sign within 1e-6; the touch readings over M g (recorded);
    the servo rollout's qpos / qvel against the PD path's (`quadruped`, the
    same start) at QPOS_TOL / QVEL_TOL; sensors card vs CPU on the same
    Data; the rate beside the flat quadruped's and the stage split."""
    import torch

    from ambersim_tpu_torch.core.types import SensorType
    from ambersim_tpu_torch.engine.forward import forward

    m = path_model("quadruped_sensors", device)
    d = forward(m, SETTLED["quadruped_sensors"])
    sd = d.sensordata

    def col(t):
        return sd[:, sensor_cols(m, t)]

    exact = {"jointpos": (col(SensorType.JOINTPOS), d.qpos[:, 7:]),
             "jointvel": (col(SensorType.JOINTVEL), d.qvel[:, 6:]),
             "actuatorfrc": (col(SensorType.ACTUATORFRC), d.actuator_force),
             "subtreecom": (col(SensorType.SUBTREECOM), d.subtree_com[:, 1])}
    for k, (a, b) in exact.items():
        if not torch.equal(a, b):
            fail(f"quadruped_sensors: {k} differs from its Data field by {(a - b).abs().max().item():.3e}")
    q, x = col(SensorType.FRAMEQUAT), d.xquat[:, 1]
    dquat = torch.minimum((q - x).abs().amax(-1), (q + x).abs().amax(-1)).max().item()
    if dquat > 1e-6:
        fail(f"quadruped_sensors: framequat parts from the trunk's xquat by {dquat:.3e}")
    weight = m.body_mass.sum() * m.opt.gravity.norm()
    touch = (col(SensorType.TOUCH).sum(1) / weight).mean().item()
    servo, pd = SETTLED["quadruped_sensors"], SETTLED["quadruped"]
    dq = (servo.qpos - pd.qpos).abs().max().item()
    dv = (servo.qvel - pd.qvel).abs().max().item()
    print(f"quadruped_sensors: jointpos, jointvel, actuatorfrc and subtreecom equal to their Data fields; framequat "
          f"within {dquat:.3e} of the trunk's xquat; touch over M g, mean over envs {touch:.4f}; servo vs PD after "
          f"{NUM_STEPS} steps: max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} (<= {QVEL_TOL})", flush=True)
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail("quadruped_sensors: the servo rollout parts from the PD rollout")
    same_input_sensors("quadruped_sensors", m, d, path_model("quadruped_sensors", "cpu"))
    split = stage_split("quadruped_sensors", device, card)
    print(f"quadruped_sensors: {STEP_MS['quadruped_sensors']:.3f} ms a step "
          f"({NUM_ENVS * 1e3 / STEP_MS['quadruped_sensors']:.1f} env-steps/s) against the flat quadruped's "
          f"{STEP_MS['quadruped']:.3f} ms in this call; sensors stage {split['sensors']:.3f} ms (median of 10) "
          f"[{card}]", flush=True)


_HAND_KERNELS = _LINALG + ("newton_structured",)


def _hand_launches(forwards: int, steps: int) -> dict:
    """Kernel launches of `forwards` forward calls and `steps` physics steps
    of the hand: a forward factors qM (kernel 1), solves qacc_smooth
    (kernel 2) and runs the Newton solve (kernel 4); a step adds Euler's
    damping solve (kernel 3)."""
    return {k: steps + (0 if k == "solve_pd" else forwards) for k in _HAND_KERNELS}


def _goal_error(xs, xg):
    """(...,) distance of the goal's joint angles (f1_spread, f1_prox)."""
    import torch

    return torch.linalg.vector_norm(xs[..., :2] - xg[:2], dim=-1)


def hand_sampling(device, card: str) -> dict:
    """BASELINE.md:13's predictive-sampling workload: HAND_OPTIMIZE_CALLS
    optimize calls of 100 samples x 10 knots, the launch counts set to 0
    just before and read just after (each call: one forward and 10 steps at
    100 envs). Checks: exact launches, a finite result, 8 samples' card
    rollout against the CPU's, and the chosen tape's cost at most the
    guess's. Returns the launch counts."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSampler, VanillaPredictiveSamplerParams, shoot

    m = hand_model(device)
    sampler = VanillaPredictiveSampler(model=m, cost_function=hand_cost(device), nsamples=HAND_SAMPLES,
                                       stdev=HAND_STDEV)
    x0 = torch.cat([hand_start(m, 1, seed=10, scale=0.3)[0], torch.zeros(m.skel.nv, device=device)])
    guess = torch.as_tensor(0.3 * np.random.default_rng(11).standard_normal((HAND_HORIZON, m.skel.nu)).astype(
        np.float32), device=device)
    params = VanillaPredictiveSamplerParams(x0=x0, us_guess=guess, generator=torch.Generator().manual_seed(0))
    sampler.optimize(params)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(HAND_OPTIMIZE_CALLS):
        xs_star, us_star = sampler.optimize(params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check_launches("hand_sampling", launches, _HAND_KERNELS, 1,
                    {k: HAND_OPTIMIZE_CALLS * n for k, n in _hand_launches(1, HAND_HORIZON).items()})
    if not (torch.isfinite(xs_star).all() and xs_star.shape == (HAND_HORIZON + 1, 16)):
        fail(f"hand_sampling: non-finite or misshapen xs_star {tuple(xs_star.shape)}")
    # 8 samples of the card's batched rollout against the CPU's
    us = sampler.draw_samples(params)
    xs = shoot(m, x0, us)
    xs_cpu = shoot(hand_model("cpu"), x0.cpu(), us[:8].cpu())
    nq = m.skel.nq
    dq = (xs[:8, :, :nq].cpu() - xs_cpu[..., :nq]).abs().max().item()
    dv = (xs[:8, :, nq:].cpu() - xs_cpu[..., nq:]).abs().max().item()
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail(f"hand_sampling: the card's shoot differs from the CPU's by {dq:.3e} / {dv:.3e}")
    # sample 0 is the guess: the chosen tape costs at most what the guess
    # rolled out alone costs, up to the rounding of a batch of 100 and of 1
    # (the JAX package's slack, tests/trajopt/test_predictive_sampler.py:84-87)
    cost = sampler.cost_function
    c_star, c_guess = cost.cost(xs_star, us_star).item(), cost.cost(shoot(m, x0, guess), guess).item()
    if not c_star <= c_guess + 1e-5 + 1e-5 * abs(c_guess):
        fail(f"hand_sampling: the chosen tape costs {c_star:.6f}, the guess {c_guess:.6f}")
    print(f"hand_sampling: {HAND_OPTIMIZE_CALLS} optimize calls of {HAND_SAMPLES} samples x {HAND_HORIZON} knots in "
          f"{seconds:.3f} s = {HAND_OPTIMIZE_CALLS / seconds:.2f} calls/s, {1e3 * seconds / HAND_OPTIMIZE_CALLS:.3f} ms "
          f"per call (eager, host-bound: each step is dispatched from Python) [{card}]; launches {launches}\n"
          f"hand_sampling: 8 samples card vs cpu over {HAND_HORIZON} steps: max |dqpos| {dq:.3e} (<= {QPOS_TOL}), "
          f"max |dqvel| {dv:.3e} (<= {QVEL_TOL}); cost of the chosen tape {c_star:.6f} <= the guess's {c_guess:.6f}",
          flush=True)
    return launches


_MESH_HAND_KERNELS = _LINALG + ("newton_dense",)


def hand_mesh_sampling(device, card: str, results) -> dict:
    """One optimize call of the mesh hand's sampler (MESH_HAND_XML, a model
    compiled by the port on `device`), the launch counts set to 0 just
    before and read just after: exact launches (a forward and HAND_HORIZON
    steps at HAND_SAMPLES envs: kernels 1, 2 and 5 each a forward and a
    step, kernel 3 each step), the timed call's xs_star against the CPU's
    rollout of the chosen sample and every sample's rollout on the card
    against the CPU's, within QPOS_TOL / QVEL_TOL, the CPU's chosen index
    (or, where its two cheapest samples tie within 1e-6 of the cost, one of
    them) and the chosen tape's cost at most the guess's. Then kernel 5 on the pre-solve operands of the
    samples' final states (the mimic rows active) against its plain version
    at the NEWTON_* bars, and its time there (SHAPE_TIMES). Returns the
    launch counts."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.ops.newton import newton_solve_dense
    from ambersim_tpu_torch.trajopt import (StaticGoalQuadraticCost, VanillaPredictiveSampler,
                                            VanillaPredictiveSamplerParams, shoot)
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    runs = {}
    for dev in (device, "cpu"):
        m = load_model_from_file(MESH_HAND_XML, solver="newton", iterations=1, ls_iterations=4, device=dev)
        nx, nu = m.skel.nq + m.skel.nv, m.skel.nu
        xg = torch.zeros(nx, device=dev)
        xg[1] = 1.0
        cost = StaticGoalQuadraticCost(Q=0.1 * torch.eye(nx, device=dev), Qf=10.0 * torch.eye(nx, device=dev),
                                       R=1e-3 * torch.eye(nu, device=dev), xg=xg)
        runs[dev] = (m, VanillaPredictiveSampler(model=m, cost_function=cost, nsamples=HAND_SAMPLES,
                                                 stdev=MESH_HAND_STDEV))
    m, sampler = runs[device]
    s = m.skel
    if not (s.ncon == 0 and s.neq == 4 and (np.asarray(s.geom_type) == 7).sum() > 0):
        fail(f"hand_mesh_sampling: want mesh geoms, 4 mimic rows and no contact pair (ncon {s.ncon}, neq {s.neq})")
    params = VanillaPredictiveSamplerParams(x0=torch.zeros(s.nq + s.nv, device=device),
                                            us_guess=torch.zeros(HAND_HORIZON, s.nu, device=device),
                                            generator=torch.Generator().manual_seed(0))
    us = sampler.draw_samples(params)
    sampler.select(params.x0, us)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xs_star, us_star, best = sampler.select(params.x0, us)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check_launches("hand_mesh_sampling", launches, _MESH_HAND_KERNELS, 1,
                    {k: HAND_HORIZON + (0 if k == "solve_pd" else 1) for k in _MESH_HAND_KERNELS})
    m_cpu, sampler_cpu = runs["cpu"]
    xs = shoot(m, params.x0, us)
    xs_cpu = shoot(m_cpu, params.x0.cpu(), us.cpu())
    nq = s.nq
    dq = (xs[..., :nq].cpu() - xs_cpu[..., :nq]).abs().max().item()
    dv = (xs[..., nq:].cpu() - xs_cpu[..., nq:]).abs().max().item()
    star = xs_star.cpu() - xs_cpu[int(best)]
    dq_star, dv_star = star[..., :nq].abs().max().item(), star[..., nq:].abs().max().item()
    costs = sampler_cpu.cost_function.cost(xs_cpu, us.cpu())
    order = costs.argsort()
    tied = [int(order[0])] + ([int(order[1])] if costs[order[1]] - costs[order[0]] <= 1e-6 * abs(costs[order[0]])
                              else [])
    c_star = costs[int(best)].item()
    print(f"hand_mesh_sampling: one optimize call of {HAND_SAMPLES} samples x {HAND_HORIZON} knots in "
          f"{1e3 * seconds:.3f} ms [{card}]; launches {launches}; {HAND_SAMPLES} samples card vs cpu: max |dqpos| "
          f"{dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} (<= {QVEL_TOL}); the timed call's xs_star against the CPU's "
          f"rollout of its sample: {dq_star:.3e}, {dv_star:.3e}; chosen sample {int(best)} (the CPU's "
          f"{tied}), cost {c_star:.6f}, the guess's {costs[0].item():.6f}", flush=True)
    if not (torch.isfinite(xs_star).all() and dq <= QPOS_TOL and dv <= QVEL_TOL and dq_star <= QPOS_TOL
            and dv_star <= QVEL_TOL):
        fail(f"hand_mesh_sampling: the card's rollouts differ from the CPU's by {dq:.3e} / {dv:.3e}, xs_star by "
             f"{dq_star:.3e} / {dv_star:.3e}")
    if int(best) not in tied or not c_star <= costs[0].item():
        fail(f"hand_mesh_sampling: the card chose sample {int(best)}, the CPU {tied}")
    if not torch.equal(us_star.cpu(), us[int(best)].cpu()):
        fail("hand_mesh_sampling: us_star is not the chosen sample")
    # kernel 5 on the mesh hand's rows: the samples' final states
    d = pre_solve(m, make_data(m, HAND_SAMPLES).replace(qpos=xs[:, -1, :nq].contiguous(),
                                                        qvel=xs[:, -1, nq:].contiguous()))
    pa = dict(solver_operands(m, d, seed=7), ne=int(s.ne), nf=int(s.nf))
    kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)

    def dense(pa=pa, kw=kw):
        q = dict(pa)
        return newton_solve_dense(q.pop("J"), q.pop("qM"), q.pop("aref"), q.pop("D"), q.pop("fl"), q.pop("act"),
                                  q.pop("a_s"), q.pop("ws"), q.pop("tol"), **q, **kw)

    what = f"newton_dense mesh hand B={HAND_SAMPLES}"
    err = newton_err(dense(), _newton_arrays(**pa, **kw), what)
    results["newton_dense"]["max_abs_err"] = max(results["newton_dense"]["max_abs_err"], err)
    SHAPE_TIMES[("newton_dense", f"mesh hand B={HAND_SAMPLES}")] = (cuda_ms(dense), newton_bound(
        [pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws")], s.nefc, s.nv, pa["act"],
        kw["iterations"], kw["ls_iterations"])["bound_ms"])
    print(f"{what}: active rows per env {pa['act'].sum(1).mean().item():.2f} of {s.nefc}, within {err:.2e} of plain; "
          f"{SHAPE_TIMES[('newton_dense', f'mesh hand B={HAND_SAMPLES}')][0]:.4f} ms, bound "
          f"{SHAPE_TIMES[('newton_dense', f'mesh hand B={HAND_SAMPLES}')][1]:.4f} ms", flush=True)
    return launches


def hand_mpc(device, card: str) -> dict:
    """run_mpc for HAND_MPC_STEPS control steps from rest, and run_mpc_batch
    over HAND_MPC_BATCH initial states (a solve is then 800 envs, the plant
    8), each with the launch counts set to 0 just before and read just
    after. Checks: exact launches, finite states, and every problem ending
    nearer the goal than the open-loop guess (the zero tape) takes it.
    Returns the launches of the solves and of the plants apart."""
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import (VanillaPredictiveSampler, VanillaPredictiveSamplerParams, run_mpc,
                                            run_mpc_batch, shoot)

    m = hand_model(device)
    s = m.skel
    sampler = VanillaPredictiveSampler(model=m, cost_function=hand_cost(device, mpc=True), nsamples=HAND_SAMPLES,
                                       stdev=HAND_MPC_STDEV)
    xg = sampler.cost_function.xg
    out = {}
    for name, batch in (("hand_mpc", 1), ("hand_mpc_batch", HAND_MPC_BATCH)):
        x0 = torch.zeros(batch, s.nq + s.nv, device=device)
        if batch > 1:
            x0[:, : s.nq] = hand_start(m, batch, seed=12, scale=0.1)
        params = VanillaPredictiveSamplerParams(x0=x0, us_guess=torch.zeros(batch, HAND_HORIZON, s.nu, device=device),
                                                generator=torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        if batch == 1:
            params = params.replace(x0=x0[0], us_guess=params.us_guess[0])
            xs, us, data = run_mpc(m, sampler, params, HAND_MPC_STEPS)
            xs, us = xs[None], us[None]
        else:
            xs, us, data = run_mpc_batch(m, sampler, params, HAND_MPC_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        solves = {k: HAND_MPC_STEPS * n for k, n in _hand_launches(1, HAND_HORIZON).items()}
        plant = _hand_launches(1, HAND_MPC_STEPS)
        _check_launches(name, launches, _HAND_KERNELS, 1, {k: solves[k] + plant[k] for k in solves})
        out[name], out[f"{name}_plant"] = solves, plant
        if not (torch.isfinite(xs).all() and xs.shape == (batch, HAND_MPC_STEPS + 1, s.nq + s.nv)
                and torch.equal(data.qpos, xs[:, -1, : s.nq])):
            fail(f"{name}: non-finite or inconsistent states")
        err = _goal_error(xs[:, -1], xg)
        err_open = _goal_error(shoot(m, x0, torch.zeros(batch, HAND_MPC_STEPS, s.nu, device=device))[:, -1], xg)
        print(f"{name}: {batch} x {HAND_MPC_STEPS} control steps (solves of {batch * HAND_SAMPLES} envs x "
              f"{HAND_HORIZON} knots, plant {batch} envs) in {seconds:.3f} s, {1e3 * seconds / HAND_MPC_STEPS:.3f} ms "
              f"per control step (eager, host-bound) [{card}]; goal angle error, the largest over the problems: start "
              f"{_goal_error(x0, xg).max().item():.4f}, closed loop {err.max().item():.4f}, open-loop guess "
              f"{err_open.max().item():.4f}; each problem's closed loop nearer by at least "
              f"{(err_open - err).min().item():.4f}; launches {launches}", flush=True)
        if not bool((err < err_open).all()):
            fail(f"{name}: the closed loop ends no nearer the goal than the open-loop guess: {err} vs {err_open}")
    return out


def hand_contacts(device, card: str) -> dict:
    """The hand at its own options with contacts on: HAND_CONTACT_ENVS x
    HAND_CONTACT_STEPS steps of HAND_CLOSING_CTRL from hand_start over the
    whole joint ranges, the launch counts set to 0 just before and read
    just after. Checks: one launch of each of kernels 1-4 a step, finite
    states, at least one active contact per env a step on average; then 8
    envs x 20 steps on the card against the CPU. Returns the launch counts."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core.types import GeomType
    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    def start(m, B):
        ctrl = torch.tensor(HAND_CLOSING_CTRL, device=m.device).expand(B, -1).contiguous()
        return make_data(m, B).replace(qpos=hand_start(m, B, seed=13, scale=1.0), ctrl=ctrl)

    m = hand_model(device, trajopt=False)
    s = m.skel
    first_contact = int(min(s.con_efcadr))
    B, steps = HAND_CONTACT_ENVS, HAND_CONTACT_STEPS
    d = start(m, B)
    rollout(m, d, 3)  # warm-up
    contacts = torch.zeros((), device=device)

    def count(d):
        contacts.add_(d.efc_active[:, first_contact:].sum())
        return d.ctrl

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    d = rollout(m, d, steps, ctrl_fn=count)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check_launches("hand_contacts", launches, _HAND_KERNELS, steps, {k: steps for k in _HAND_KERNELS})
    for field in ("qpos", "qvel", "qacc", "efc_force"):
        if not torch.isfinite(getattr(d, field)).all():
            fail(f"hand_contacts: non-finite {field}")
    # rows of the steps before each of steps 2..100 and after the last; 4 rows a contact
    per_env = (contacts + d.efc_active[:, first_contact:].sum()).item() / 4 / (B * steps)
    act = d.efc_active[:, first_contact:].reshape(B, -1, 4)[..., 0].cpu().numpy()
    types = np.asarray(s.geom_type)
    g1, g2 = d.contact.geom1.cpu().numpy(), d.contact.geom2.cpu().numpy()
    pairs = {}
    for b, c in zip(*np.nonzero(act)):
        key = f"{GeomType(int(types[g1[b, c]])).name.lower()}-{GeomType(int(types[g2[b, c]])).name.lower()}"
        pairs[key] = pairs.get(key, 0) + 1
    print(f"hand_contacts: {B} envs x {steps} steps in {seconds:.3f} s = {B * steps / seconds:.1f} env-steps/s, "
          f"{1e3 * seconds / steps:.3f} ms per step [{card}]; active contacts per env, mean over the steps "
          f"{per_env:.3f}; active contacts at the last step by geom pair {pairs}; launches {launches}", flush=True)
    if not per_env >= 1.0:
        fail(f"hand_contacts: {per_env:.3f} active contacts per env a step, want >= 1")
    runs = [rollout(mm, start(mm, 8), 20) for mm in (hand_model(device, trajopt=False), hand_model("cpu", trajopt=False))]
    dq = (runs[0].qpos.cpu() - runs[1].qpos).abs().max().item()
    dv = (runs[0].qvel.cpu() - runs[1].qvel).abs().max().item()
    print(f"hand_contacts card vs cpu after 20 steps: max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} "
          f"(<= {QVEL_TOL}); active contacts per env {runs[1].efc_active[:, first_contact:].sum(1).float().mean().item() / 4:.2f}")
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail("hand_contacts: card rollout disagrees with the CPU rollout")
    return launches


def humanoid_sampler(device, **opt):
    """benchmarks/ladder.py rung 5's predictive sampler on the humanoid (its
    own options, or `opt` overrides), with its params: x0 and the goal at
    (qpos0, 0), a zero guess, draws from a CPU generator seeded 0."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.trajopt import (StaticGoalQuadraticCost, VanillaPredictiveSampler,
                                            VanillaPredictiveSamplerParams)

    m = load_model("humanoid", device=device)
    if opt:
        m = m.replace(opt=m.opt.replace(**opt))
    s = m.skel
    nx = s.nq + s.nv
    x0 = torch.cat([m.qpos0, torch.zeros(s.nv, device=m.device)])
    eye = torch.eye(nx, device=m.device)
    cost = StaticGoalQuadraticCost(Q=0.1 * eye, Qf=10.0 * eye, R=1e-4 * torch.eye(s.nu, device=m.device), xg=x0)
    sampler = VanillaPredictiveSampler(model=m, cost_function=cost, nsamples=HUMANOID_SAMPLES, stdev=HUMANOID_STDEV)
    params = VanillaPredictiveSamplerParams(x0=x0, us_guess=torch.zeros(HUMANOID_HORIZON, s.nu, device=m.device),
                                            generator=torch.Generator().manual_seed(0))
    return sampler, params


def humanoid_sampling(device, card: str) -> dict:
    """benchmarks/ladder.py rung 5's humanoid predictive sampling:
    HUMANOID_OPTIMIZE_CALLS optimize calls of 64 samples x 8 knots at the
    humanoid's own options (contacts on, Newton 4 x 8), the launch counts
    set to 0 just before and read just after (each call: one forward and 8
    steps at 64 envs). Checks: exact launches, a finite result, the chosen
    tape's cost at most the guess's, and 8 samples' card rollout against the
    CPU's at QPOS_TOL / QVEL_TOL, at the humanoid's own options and with the
    solve converged (CONVERGED: at 4 x 8 a take/keep decision of the last
    iteration can turn on float32 rounding where ~12 contacts touch the
    floor at qpos0, as tests/test_torch_humanoid_sampling.py records against
    the JAX package). Returns the launch counts."""
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import shoot

    sampler, params = humanoid_sampler(device)
    sampler.optimize(params)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(HUMANOID_OPTIMIZE_CALLS):
        xs_star, us_star = sampler.optimize(params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check_launches("humanoid_sampling", launches, _HAND_KERNELS, 1,
                    {k: HUMANOID_OPTIMIZE_CALLS * n for k, n in _hand_launches(1, HUMANOID_HORIZON).items()})
    m, x0 = sampler.model, params.x0
    if not (torch.isfinite(xs_star).all() and xs_star.shape == (HUMANOID_HORIZON + 1, m.skel.nq + m.skel.nv)):
        fail(f"humanoid_sampling: non-finite or misshapen xs_star {tuple(xs_star.shape)}")
    cost = sampler.cost_function
    c_star = cost.cost(xs_star, us_star).item()
    c_guess = cost.cost(shoot(m, x0, params.us_guess), params.us_guess).item()
    if not c_star <= c_guess + 1e-5 + 1e-5 * abs(c_guess):
        fail(f"humanoid_sampling: the chosen tape costs {c_star:.6f}, the guess {c_guess:.6f}")
    us = sampler.draw_samples(params)[:8]
    nq, diffs = m.skel.nq, {}
    for what, opt in (("converged", CONVERGED), ("own options", {})):
        xs = [shoot(humanoid_sampler(dev, **opt)[0].model, x0.to(dev), us.to(dev)).cpu() for dev in (device, "cpu")]
        diffs[what] = ((xs[0][..., :nq] - xs[1][..., :nq]).abs().max().item(),
                       (xs[0][..., nq:] - xs[1][..., nq:]).abs().max().item())
    print(f"humanoid_sampling: {HUMANOID_OPTIMIZE_CALLS} optimize calls of {HUMANOID_SAMPLES} samples x "
          f"{HUMANOID_HORIZON} knots in {seconds:.3f} s = {HUMANOID_OPTIMIZE_CALLS / seconds:.2f} calls/s, "
          f"{1e3 * seconds / HUMANOID_OPTIMIZE_CALLS:.3f} ms per call [{card}]; launches {launches}\n"
          f"humanoid_sampling: 8 samples card vs cpu over {HUMANOID_HORIZON} steps, max |dqpos| / |dqvel| (<= "
          f"{QPOS_TOL} / {QVEL_TOL}): at the humanoid's own options {diffs['own options'][0]:.3e} / "
          f"{diffs['own options'][1]:.3e}, converged {diffs['converged'][0]:.3e} / {diffs['converged'][1]:.3e}; "
          f"cost of the chosen tape {c_star:.6f} <= the guess's {c_guess:.6f}", flush=True)
    if not all(dq <= QPOS_TOL and dv <= QVEL_TOL for dq, dv in diffs.values()):
        fail(f"humanoid_sampling: the card's shoot differs from the CPU's: {diffs}")
    return launches


def pendulum_single(device, card: str) -> dict:
    """benchmarks/ladder.py rung 1: the pendulum at a batch of one for
    PENDULUM_STEPS steps, the launch counts set to 0 just before and read
    just after (no constraint rows and no damping: one factor and one solve
    of qM a step). It starts 1 rad from qpos0, so that it swings (the
    ladder's start hangs at rest; a step's work is the same). Checks: exact
    launches, a finite state, and the card against the same steps on the
    CPU at QPOS_TOL / QVEL_TOL. Returns the launch counts."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    def start(dev):
        m = load_model("pendulum", device=dev)
        return m, make_data(m, 1).replace(qpos=m.qpos0[None] + 1.0)

    m, d0 = start(device)
    rollout(m, d0, 3)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    d = rollout(m, d0, PENDULUM_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check_launches("pendulum_single", launches, ("cholesky", "cho_solve"), PENDULUM_STEPS,
                    {"cholesky": PENDULUM_STEPS, "cho_solve": PENDULUM_STEPS})
    cpu = rollout(*start("cpu"), PENDULUM_STEPS)
    dq = (d.qpos.cpu() - cpu.qpos).abs().max().item()
    dv = (d.qvel.cpu() - cpu.qvel).abs().max().item()
    print(f"pendulum_single: 1 env x {PENDULUM_STEPS} steps in {seconds:.3f} s = {PENDULUM_STEPS / seconds:.1f} "
          f"env-steps/s, {1e3 * seconds / PENDULUM_STEPS:.3f} ms per step [{card}]; launches {launches}; card vs cpu "
          f"after {PENDULUM_STEPS} steps: max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} "
          f"(<= {QVEL_TOL})", flush=True)
    if not (torch.isfinite(d.qpos).all() and dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail("pendulum_single: non-finite, or the card's rollout disagrees with the CPU's")
    return launches


def mesh_mesh_memory(device) -> None:
    """The mesh-mesh narrowphase's device memory: MESH_MESH_PAIRS rock-rock
    pairs (186 x 186 edge axes a pair, each projected on 2 x 64 vertices)
    at seeded random poses; the peak allocated over the call, per pair and
    times the ladder's 2048 envs (one pair an env). No ladder path launches
    it."""
    import numpy as np
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core import math as am
    from ambersim_tpu_torch.engine import collision

    P = MESH_MESH_PAIRS
    rock = load_model("rock", device=device)
    n = int(rock.skel.mesh_vertnum[0])
    mesh = tuple(x[0].expand((P,) + x.shape[1:]) for x in (
        rock.mesh_vert, (torch.arange(rock.mesh_vert.shape[1], device=device) < n)[None], rock.mesh_face_normal,
        rock.mesh_face_dist, rock.mesh_face_vert, rock.mesh_edge))
    rng = np.random.default_rng(14)
    poses = []
    for _ in range(2):
        q = torch.as_tensor(rng.standard_normal((P, 4)).astype(np.float32), device=device)
        poses += [torch.as_tensor((0.08 * rng.standard_normal((P, 3))).astype(np.float32), device=device),
                  am.quat_to_mat(q / q.norm(dim=-1, keepdim=True)), torch.zeros(P, 3, device=device)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist, pos, frame = collision.mesh_mesh(*poses, mesh, mesh)
    torch.cuda.synchronize()
    per_pair = (torch.cuda.max_memory_allocated() - base) / P
    if not (torch.isfinite(dist).all() and torch.isfinite(pos).all()):
        fail("mesh_mesh: non-finite output")
    print(f"mesh_mesh: {P} rock-rock pairs peak {per_pair * P / 2**30:.3f} GiB over the call, {per_pair / 2**20:.1f} "
          f"MiB a pair; at {DROP_ENVS} envs x 1 pair {per_pair * DROP_ENVS / 2**30:.1f} GiB", flush=True)


def check_newton_ladder(device, results) -> None:
    """Kernel 4 on the operands of the ladder paths this run added: the
    drop_scene and rock paths' final states (SETTLED, 2048 envs) and the
    humanoid sampler's 64 samples after 4 of their knots, on those of the
    model-I/O paths: the gripper's and the grasp scene's final states
    (SETTLED, 1024 envs), and on the terrain quadruped's final state
    (SETTLED, 4096 envs, nefc 296), each with a warmstart of qacc_smooth +
    0.1 N(0, 1). Against its plain version at the NEWTON_* bars where plain
    float32 meets float64 there on at least NEWTON_MIN_SHARE of the envs,
    else against float64 (vs_float64, as the hand with contacts) by the
    case's comparator; the shares are printed. The ladder's comparator is
    newton_within. The model-I/O cases' is conditioned_within: both
    floating scenes carry light fingers on a heavier base (the gripper's qM
    has cond ~7.9e3), so qacc = M^-1 (...) rounds in float32 by cond(qM) x
    u beyond any solver's order, and plain float32 meets float64 on the
    gripper's qacc at the NEWTON_* bars on only 16-29% of the envs; its
    forces agree at those bars. Then kernel 4's time at each shape
    (SHAPE_TIMES) beside its resident envs per SM, and on the terrain's
    beside its plain version's."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import forward, make_data, step
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured, structured_occupancy

    def humanoid_state():
        sampler, params = humanoid_sampler(device)
        m, us = sampler.model, sampler.draw_samples(params)
        nq = m.skel.nq
        x0 = params.x0.expand(HUMANOID_SAMPLES, -1)
        d = forward(m, make_data(m, HUMANOID_SAMPLES).replace(qpos=x0[:, :nq].contiguous(),
                                                                qvel=x0[:, nq:].contiguous()))
        for k in range(4):
            d = step(m, d.replace(ctrl=us[:, k].contiguous()))
        return m, d

    err = results["newton_structured"]["max_abs_err"]
    # (case, its model and state, the operands' seed, whether its float64
    # comparison is conditioned_within)
    cases = (("drop_scene", lambda: (load_model("drop_scene", device=device), SETTLED["drop_scene"]), 12, False),
             ("rock", lambda: (load_model("rock", device=device), SETTLED["rock"]), 12, False),
             ("humanoid sampling", humanoid_state, 12, False),
             ("gripper", lambda: (gripper_model(device), SETTLED["gripper_urdf"]), 23, True),
             ("grasp scene", lambda: (grasp_model(device), SETTLED["grasp_scene"]), 23, True),
             ("quadruped_terrain", lambda: (path_model("quadruped_terrain", device), SETTLED["quadruped_terrain"]), 12,
              False))
    for case, state, seed, conditioned in cases:
        m, d = state()
        s = m.skel
        st = _pyramid_structure(s)
        d = pre_solve(m, d)
        pa = solver_operands(m, d, seed=seed)
        kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
        what = f"newton_structured {case} (nefc {s.nefc}, nv {s.nv}{f', nd_eq {st.nd_eq}' if st.nd_eq else ''})"

        def kern(pa=pa, d=d, st=st, kw=kw):
            return newton_solve_structured(pa["J"], d.efc_bJ, d.efc_dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"],
                                           pa["act"], pa["a_s"], pa["ws"], pa["tol"], st=st, **kw)

        def ref(dtype=torch.float32, pa=pa, kw=kw, s=s):
            return _newton_arrays(**as_dtype(pa, dtype), ne=int(s.ne), nf=int(s.nf), **kw)

        got, plain, exact = kern(), ref(), ref(torch.float64)
        print(f"{what}: active rows per env {pa['act'].sum(1).mean().item():.2f} of {s.nefc}")
        within = newton_within
        if conditioned:
            within = conditioned_within(pa["qM"])
            print(f"{what}: qacc's distance from float64 over cond(qM) x u x max|qacc| (beyond the NEWTON_* "
                  f"bars), largest over the envs: plain float32 {conditioned_factor(plain, exact, pa['qM']):.4f}, "
                  f"kernel {conditioned_factor(got, exact, pa['qM']):.4f} (CONDITIONED_QACC {CONDITIONED_QACC})")
        if newton_within(plain, exact).double().mean().item() >= NEWTON_MIN_SHARE:
            err = max(err, newton_err(got, plain, what))
            newton_err(plain, exact, f"{what}, plain float32 vs float64")
        else:
            vs_float64(got, plain, exact, what, within=within)
        operands = [d.efc_bJ, d.efc_dsc] + [pa[k] for k in ("qM", "aref", "D", "fl", "act", "a_s", "ws")]
        SHAPE_TIMES[("newton_structured", case)] = (cuda_ms(kern), newton_bound(
            operands, s.nefc, s.nv, pa["act"], kw["iterations"], kw["ls_iterations"])["bound_ms"])
        ms, bound_ms = SHAPE_TIMES[("newton_structured", case)]
        plain = f", plain {plain_ms(ref):.4f} ms" if case == "quadruped_terrain" else ""
        print(f"kernel newton_structured: {case} B={pa['J'].shape[0]} {ms:.4f} ms{plain}, bound {bound_ms:.4f} ms; "
              f"{structured_occupancy(s.nv, s.nefc, st)} envs resident per SM", flush=True)
    results["newton_structured"]["max_abs_err"] = err


def _check_launches(what: str, launches: dict, kernels: tuple, at_least: int, exactly: dict | None = None) -> None:
    """Each of `kernels` launched at least `at_least` times, or as many times
    as `exactly` says when it is given; no other kernel at all."""
    for k, n in launches.items():
        if exactly is not None and n != exactly.get(k, 0):
            fail(f"{what}: kernel {k} launched {n} times, want exactly {exactly.get(k, 0)}")
        if k in kernels and n < at_least:
            fail(f"{what}: kernel {k} launched {n} times for {at_least} physics steps")
        if k not in kernels and n:
            fail(f"{what}: kernel {k} launched {n} times, not one of the path's")


def _recording_networks(initial: dict):
    """make_ppo_networks whose init also keeps a copy of the initial params in
    `initial` (under "policy" and "value")."""
    from ambersim_tpu_torch.rl.ppo import networks

    def factory(obs_size, action_size, preprocess_observations_fn):
        nets = networks.make_ppo_networks(obs_size, action_size, preprocess_observations_fn=preprocess_observations_fn)

        def recording(name, net):
            def init(generator):
                params = net.init(generator)
                initial[name] = {k: v.clone() for k, v in params.items()}
                return params

            return networks.FeedForwardNetwork(init=init, apply=net.apply)

        return networks.PPONetworks(recording("policy", nets.policy_network), recording("value", nets.value_network),
                                    nets.parametric_action_distribution)

    return factory


def ppo_training_step(name: str, env_name: str, c: dict, device, card: str, env_kwargs: dict | None = None) -> dict:
    """One PPO training step of `env_name`'s policy (built with
    `env_kwargs`) at the settings `c`, with the launch counts set to 0 just
    before and read just after. Checks the launches, finite losses and eval
    rewards, moved params and the normalizer's count. Returns the launch
    counts."""
    import math
    import tempfile

    import torch

    from ambersim_tpu_torch.io.checkpoint import load_params
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl import get_environment
    from ambersim_tpu_torch.rl.ppo import train

    env = get_environment(env_name, device=device, **(env_kwargs or {}))
    physics = env.config.physics_steps_per_control_step
    num_unrolls = c["batch_size"] * c["num_minibatches"] // c["num_envs"]
    train_steps = num_unrolls * c["unroll_length"] * physics
    eval_steps = c["num_evals"] * c["episode_length"] * physics
    initial, marks = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "state.pkl"
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, (normalizer, _), metrics = train(
            env, device=device, network_factory=_recording_networks(initial),
            progress_fn=lambda step, m: marks.append((time.perf_counter(), step, m)), checkpoint_path=str(ckpt), **c,
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        final = load_params(ckpt, device=device)["params"]
    _check_launches(name, launches, _LINALG + ("newton_structured",), train_steps + eval_steps)
    for k, v in metrics.items():
        if not math.isfinite(v):
            fail(f"{name}: {k} = {v}")
    rewards = [m["eval/episode_reward"] for _, _, m in marks]
    if len(marks) != 2 or not all(math.isfinite(r) for r in rewards):
        fail(f"{name}: eval rewards {rewards}")
    for net in ("policy", "value"):
        moved = max((final[net][k] - v).abs().max().item() for k, v in initial[net].items())
        if not moved > 0:
            fail(f"{name}: the {net} params did not change")
        print(f"{name}: {net} params moved by up to {moved:.3e}")
    count = float(normalizer.count)
    if count != c["num_envs"] * num_unrolls * c["unroll_length"]:
        fail(f"{name}: normalizer count {count}")
    rollout_s, sgd_s, eval_s = metrics["timing/rollout_s"], metrics["timing/sgd_s"], metrics["timing/eval_s"]
    env_steps = marks[-1][1]
    first_update = marks[0][0] - t0 + rollout_s + sgd_s
    print(
        f"{name}: {c['num_envs']} envs, {env_steps} env steps ({train_steps} physics steps) + 2 evals of "
        f"{c['num_eval_envs']} envs ({eval_steps} physics steps) in {seconds:.3f} s; launches {launches}\n"
        f"{name}: training {env_steps / (rollout_s + sgd_s):.1f} env-steps/s; rollout {rollout_s:.3f} s, "
        f"SGD {sgd_s:.3f} s, eval {eval_s:.3f} s; set-up + initial eval {marks[0][0] - t0:.3f} s; "
        f"first update after {first_update:.3f} s [{card}]\n"
        f"{name}: eval reward {rewards[0]:.3f} -> {rewards[1]:.3f}; losses "
        + ", ".join(f"{k[len('training/'):]} {v:.4f}" for k, v in metrics.items() if k.startswith("training/")),
        flush=True,
    )
    return launches


def ppo_pendulum_learns(device, card: str) -> dict:
    """PPO on the pendulum swingup must gain at least half the JAX package's
    mean gain; returns the launch counts of the run."""
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupConfig, PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo import train

    c = PPO_PENDULUM
    config = PendulumSwingupConfig(physics_steps_per_control_step=2)
    num_unrolls = c["batch_size"] * c["num_minibatches"] // c["num_envs"]
    per_step = c["num_envs"] * num_unrolls * c["unroll_length"]
    training_steps = (c["num_evals"] - 1) * -(-c["num_timesteps"] // (per_step * (c["num_evals"] - 1)))
    physics = (training_steps * num_unrolls * c["unroll_length"] + c["num_evals"] * c["episode_length"]) * 2
    marks = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    train(PendulumSwingupEnv(config), device=device, progress_fn=lambda step, m: marks.append((step, m)), **c)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # nefc = 0 and no joint damping: only the factor of qM and qacc_smooth's solve
    _check_launches("ppo_pendulum_learns", launches, ("cholesky", "cho_solve"), physics)
    rewards = [m["eval/episode_reward"] for _, m in marks]
    gain, bar = rewards[-1] - rewards[0], 0.5 * sum(JAX_PENDULUM_GAINS) / len(JAX_PENDULUM_GAINS)
    print(f"ppo_pendulum_learns: {marks[-1][0]} env steps in {seconds:.3f} s [{card}]; eval rewards "
          f"{', '.join(f'{r:.1f}' for r in rewards)}; gain {gain:.1f} (bar {bar:.1f}, half the JAX package's mean "
          f"gain {2 * bar:.1f}); launches {launches}", flush=True)
    if not gain >= bar:
        fail(f"ppo_pendulum_learns: the policy gained {gain:.1f} eval reward, under the bar {bar:.1f}")
    return launches


def _grad_share(got: dict, want: dict, envs: int) -> tuple[float, float]:
    """Over the inputs of `want`: the smallest share of the first `envs`
    envs whose largest |got - want| gradient entry is within GRAD_TOL of
    want's largest |entry| (non-finite entries must sit where want's are),
    and the largest difference over that scale."""
    import torch

    worst_rel, worst_share = 0.0, 1.0
    for k, w in want.items():
        g = got[k][:envs].detach().cpu().to(w.dtype)
        if g.shape != w.shape:
            fail(f"gradient d/d{k}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
        same_nonfinite = (torch.isfinite(g) == torch.isfinite(w)).flatten(1).all(1)
        err = (torch.nan_to_num(g) - torch.nan_to_num(w)).abs().flatten(1).amax(1)
        scale = torch.nan_to_num(w).abs().max().item()
        worst_share = min(worst_share, (same_nonfinite & (err <= GRAD_TOL * scale)).double().mean().item())
        worst_rel = max(worst_rel, err.max().item() / max(scale, 1e-30))
    return worst_rel, worst_share


def grad_cases(device) -> dict:
    """kernel -> (its dispatch call, the plain version, inputs on the card,
    the inputs that take a gradient, statics, the statics compared at, the
    JSON row's shape): kernels 1-3 on random SPD systems at (4096, 18) and
    (256, 192), kernels 4-6 on the pre-solve operands of their check phases
    (the quadruped at 4096, arm3 at 1024 after 100 steps, the elliptic
    quadruped at 4096). The elliptic solve is compared converged (CONVERGED,
    as its forward is: at 3 x 6 iterations it is chaotic in float32) and
    timed at the model's options."""
    import numpy as np

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import linalg, rollout, solver
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    rng = np.random.default_rng(40)
    cases = {}
    for B, n, suffix in ((NUM_ENVS, 18, ""), (CLUTTER_ENVS, 192, "_block")):
        a, b = random_spd(rng, B, n, device)
        l = linalg.cholesky_unrolled(a)
        shape = f"B={B}, n={n}"
        for name, inputs in (("cholesky", dict(a=a)), ("cho_solve", dict(l=l, b=b)), ("solve_pd", dict(a=a, b=b))):
            cases[name + suffix] = (getattr(linalg, f"{name}_kernel"), getattr(linalg, f"{name}_unrolled"), inputs,
                                    tuple(inputs), {}, {}, shape)
    rows = ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol")
    wrt = ("J", "qM", "aref", "D", "fl", "a_s", "ws")

    def options(m):
        return dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)

    m = load_model("quadruped", device=device)
    s = m.skel
    d = initial_batch(m, NUM_ENVS, device)
    d = pre_solve(m, d.replace(ctrl=pd_ctrl(d)))
    pa = solver_operands(m, d, seed=2)
    statics = dict(st=_pyramid_structure(s), ne=int(s.ne), nf=int(s.nf), **options(m))
    cases["newton_structured"] = (solver.newton_structured, solver._structured_plain,
                                  dict(J=pa["J"], bJ=d.efc_bJ, dsc=d.efc_dsc, **{k: pa[k] for k in rows[1:]}),
                                  wrt + ("bJ", "dsc"), statics, statics,
                                  f"quadruped B={NUM_ENVS}, nefc={s.nefc}, nv={s.nv}")
    m = load_model("arm3", device=device)
    s = m.skel
    d = pre_solve(m, rollout(m, PATHS["arm3"]["start"](m, 1024, device), 100))
    pa = solver_operands(m, d, seed=4)
    statics = dict(ne=int(s.ne), nf=int(s.nf), **options(m))
    cases["newton_dense"] = (solver.newton_dense, solver._newton_arrays, {k: pa[k] for k in rows}, wrt, statics,
                             statics, f"arm3 B=1024, nefc={s.nefc}, nv={s.nv}")
    m = load_model("quadruped_elliptic", device=device)
    s = m.skel
    cdim, slots, base, _ = solver.elliptic_tail(s)
    d = initial_batch(m, NUM_ENVS, device)
    d = pre_solve(m, d.replace(ctrl=pd_ctrl(d)))
    pa = solver_operands(m, d, seed=6)
    statics = dict(impratio=m.opt.impratio, ne=int(s.ne), nf=int(s.nf), base=base, ncon=len(slots), cdim=cdim,
                   use_ws=True)
    cases["newton_elliptic"] = (solver.newton_elliptic, solver._elliptic_plain,
                                dict({k: pa[k] for k in rows}, fr=d.contact.friction), wrt, dict(statics, **options(m)),
                                dict(statics, **CONVERGED),
                                f"elliptic quadruped B={NUM_ENVS}, nefc={s.nefc}, nv={s.nv}")
    return cases


def _on(statics: dict, device, dtype=None) -> dict:
    import torch

    return {k: v.to(device, dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else
            v.to(device) if isinstance(v, torch.Tensor) else v for k, v in statics.items()}


def _linear_grads(call, inputs: dict, names, weights, **statics) -> dict:
    """Gradients of sum_i (weights_i * outputs_i).sum() of call(*inputs)
    with respect to the inputs named in `names` (None where unused)."""
    import torch

    leaves = {n: v.detach().clone().requires_grad_(n in names) for n, v in inputs.items()}
    outs = call(*leaves.values(), **statics)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((w.to(o.dtype) * o).sum() for w, o in zip(weights, outs))
    return dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)))


def grad_kernels(device, results) -> None:
    """Each of the nine kernel routes' gradient on the card (its Function:
    the kernel forward, autograd through the plain version backward) of a
    seeded linear functional of its outputs, against the plain version's
    gradient on the CPU from the same inputs, at each JSON row's shape, input
    by input: every env within GRAD_TOL for kernels 1-3; GRAD_MIN_SHARE of
    the envs for the Newton routes or, for an input under it, the card's
    share within GRAD_TOL of the float64 gradient at most GRAD_F64_SLACK
    under plain float32's (vs_float64's rule). Kernel 4's factored operands
    must get no gradient. Records each row's backward_ms: CUDA-event time of the
    Function's backward at the row's shape (the graph kept, autograd.grad
    again)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES

    for k, (call, plain, inputs, wrt, statics, compared, shape) in grad_cases(device).items():
        names = [n for n in wrt if n not in ("bJ", "dsc")]
        # the backward's time at the row's shape and statics, through the Function
        leaves = {n: v.detach().clone().requires_grad_(n in wrt) for n, v in inputs.items()}
        launched = LAUNCHES[k]
        outs = call(*leaves.values(), **statics)
        outs = outs if isinstance(outs, tuple) else (outs,)
        if LAUNCHES[k] != launched + 1:
            fail(f"grad_kernels {k}: the Function launched the kernel {LAUNCHES[k] - launched} times, want 1")
        rng = np.random.default_rng(41)
        weights = [torch.as_tensor(rng.standard_normal(o.shape).astype(np.float32), device=device) for o in outs]
        loss = sum((w * o).sum() for w, o in zip(weights, outs))
        unread = [leaves[n] for n in wrt if n not in names]
        if unread and any(g is not None for g in torch.autograd.grad(loss, unread, retain_graph=True,
                                                                     allow_unused=True)):
            fail("grad_kernels newton_structured: efc_bJ or efc_dsc got a gradient (the plain version reads J)")
        # 2 x 1 calls after the warm one (3 x 2 until the condim and
        # integrator phases came): a backward here is 14-330 ms
        ms = cuda_ms(lambda: torch.autograd.grad(loss, [leaves[n] for n in names], retain_graph=True), reps=2,
                     calls=1)
        results[k]["backward_ms"] = ms
        del leaves, outs, loss
        # the comparison, at the compared statics, on the first envs on the CPU
        got = _linear_grads(call, inputs, names, weights, **compared)
        for n in names:
            if got[n] is None or not torch.isfinite(got[n]).all():
                fail(f"grad_kernels {k}: d/d{n} missing or not finite on the card")
        B = next(iter(inputs.values())).shape[0]
        envs = min(B, GRAD_CPU_ENVS if k.startswith("newton") else GRAD_CPU_SYSTEMS)
        cpu = {n: (v[:envs] if v.shape[0] == B else v).cpu() for n, v in inputs.items()}
        weights_cpu = [w[:envs].cpu() for w in weights]
        want = _linear_grads(plain, cpu, names, weights_cpu, **_on(compared, "cpu"))
        newton = k.startswith("newton")
        exact = None
        parts, worst = [], 0.0
        for n in names:
            rel, share = _grad_share(got, {n: want[n]}, envs)
            worst = max(worst, rel)
            part = f"{n} {share:.4f}"
            if newton and share < GRAD_MIN_SHARE:
                if exact is None:
                    exact = _linear_grads(plain, {i: v.double() if v.is_floating_point() else v for i, v in cpu.items()},
                                          names, weights_cpu, **_on(compared, "cpu", torch.float64))
                _, plain_exact = _grad_share(want, {n: exact[n]}, envs)
                _, card_exact = _grad_share(got, {n: exact[n]}, envs)
                part += f" (of float64: plain float32 {plain_exact:.4f}, card {card_exact:.4f})"
                if card_exact < plain_exact - GRAD_F64_SLACK:
                    fail(f"grad_kernels {k} d/d{n}: the card's gradient meets float64 on {card_exact:.4f} of envs, "
                         f"plain float32's on {plain_exact:.4f} (slack {GRAD_F64_SLACK})")
            elif share < (GRAD_MIN_SHARE if newton else 1.0):
                fail(f"grad_kernels {k} d/d{n}: {share:.4f} of envs within {GRAD_TOL} of the largest |g|")
            parts.append(part)
        line = (f"grad_kernels {k} ({shape}): card vs CPU over {envs} envs, largest difference {worst:.3e} of the "
                f"largest |g|; share of envs within {GRAD_TOL} by input: {', '.join(parts)}")
        print(f"{line}; backward {ms:.4f} ms at the row's shape (the plain version's autograd on the card)",
              flush=True)


def _per_call_launches(m, device) -> tuple[dict, dict]:
    """Launches of one forward and of one step of model `m` at one env,
    without grad: the unit counts the gradient phases multiply."""
    import torch

    from ambersim_tpu_torch.engine import forward, make_data, step
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    with torch.no_grad():
        d = make_data(m, 1)
        reset_launch_counts()
        d = forward(m, d)
        per_forward = dict(LAUNCHES)
        reset_launch_counts()
        step(m, d)
        per_step = dict(LAUNCHES)
    torch.cuda.synchronize()
    return per_forward, per_step


def _expect(per_forward: dict, per_step: dict, forwards: int, steps: int) -> dict:
    return {k: forwards * per_forward[k] + steps * per_step[k] for k in per_step}


def grad_path_start(name: str, m, B: int, device):
    """Data of B envs at path `name`'s start (the pendulum 1 rad off qpos0,
    the hand from hand_start, clutter at its committed settled state)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    if name == "pendulum":
        return make_data(m, B).replace(qpos=m.qpos0.expand(B, -1) + 1.0)
    if name == "hand":
        return make_data(m, B).replace(qpos=hand_start(m, B, seed=12, scale=0.5))
    if name.startswith("clutter"):
        return clutter_settled_start(m, B, device)
    return PATHS[name]["start"](m, B, device)


def grad_path_model(name: str, device):
    """GRAD_PATHS path `name`'s model on `device`, with its solver options."""
    from ambersim_tpu_torch import load_model

    model, _, _, opt = GRAD_PATHS[name]
    m = hand_model(device) if name == "hand" else model(device) if callable(model) else load_model(model, device=device)
    return m.replace(opt=m.opt.replace(**opt)) if opt else m


def grad_path(name: str, device) -> tuple[dict, dict, float]:
    """d(sum qpos + sum qvel after T steps)/d(ctrl tape, initial qvel) of
    one GRAD_PATHS path on `device` (grad mode through the engine's
    dispatch; a seeded 0.3 N(0, 1) ctrl tape). Returns the gradients, the
    launches and the backward's host seconds."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import step
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    _, B, T, _ = GRAD_PATHS[name]
    m = grad_path_model(name, device)
    d = grad_path_start(name, m, B, device)
    nu = m.skel.nu
    u = torch.as_tensor(0.3 * np.random.default_rng(42).standard_normal((T, B, nu)).astype(np.float32),
                        device=device).requires_grad_(True)
    qvel0 = d.qvel.detach().clone().requires_grad_(True)
    d = d.replace(qvel=qvel0)
    reset_launch_counts()
    for k in range(T):
        d = step(m, d.replace(ctrl=u[k]))
    loss = d.qpos.sum() + d.qvel.sum()
    t0 = time.perf_counter()
    gu, gv = torch.autograd.grad(loss, (u, qvel0), allow_unused=True)  # clutter has no actuators
    if device != "cpu":
        torch.cuda.synchronize()
    gu = torch.zeros_like(u) if gu is None else gu
    return dict(ctrl=gu.transpose(0, 1), qvel=gv), dict(LAUNCHES), time.perf_counter() - t0


def grad_paths(device, card: str) -> dict:
    """Each GRAD_PATHS path's gradient on the card against the CPU's (every
    env within GRAD_TOL of the largest |g|, the elliptic quadruped within
    GRAD_ELLIPTIC_PATH_TOL), with its peak device memory and
    exact launches (one forward pass: the step's kernels once a step).
    Returns the launch counts by phase (grad_<path>)."""
    import torch

    phases = {}
    for name, (_, B, T, _) in GRAD_PATHS.items():
        per_forward, per_step = _per_call_launches(grad_path_model(name, device), device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        got, launches, backward_s = grad_path(name, device)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        want, _, _ = grad_path(name, "cpu")
        for k, g in got.items():
            if not torch.isfinite(g).all():
                fail(f"grad_paths {name}: d/d{k} not finite on the card")
        rel, _ = _grad_share(got, {k: v for k, v in want.items() if v.numel()}, B)
        tol = GRAD_ELLIPTIC_PATH_TOL if name == "quadruped_elliptic" else GRAD_TOL
        if not rel <= tol:
            fail(f"grad_paths {name}: an env's gradient differs by {rel:.3e} of the largest |g| (bar {tol})")
        expected = _expect(per_forward, per_step, 0, T)
        _check_launches(f"grad_paths {name}", launches, tuple(k for k, n in expected.items() if n), 1, expected)
        phases[f"grad_{name}"] = launches
        if name == "quadruped_noslip":  # its M^-1 J^T launch of each step, weighed at its own shape
            phases[f"grad_{name}"] = dict(launches, cho_solve=launches["cho_solve"] - T)
            phases[f"grad_{name}_rhs"] = {"cho_solve": T}
        print(f"grad_paths {name}: {B} envs x {T} steps, d(sum qpos + sum qvel)/d(ctrl, qvel0) card vs CPU: largest "
              f"difference {rel:.3e} of the largest |g| (bar {tol}); forward + backward "
              f"{seconds:.3f} s (backward {backward_s:.3f} s); peak device memory {peak:.3f} GiB ({peak - held:.3f} "
              f"above what was held) [{card}]; launches {launches}", flush=True)
    return phases


def _apg_first_update(device, seed: int = 0):
    """The first APG update's loss and grad norm at APG_PENDULUM's width
    over APG_FIRST_EPISODE control steps: params from a CPU generator,
    starts drawn by a CPU generator, so the card and the CPU start from the
    same bits."""
    import torch

    from ambersim_tpu_torch.rl import wrappers
    from ambersim_tpu_torch.rl.apg import make_apg_networks
    from ambersim_tpu_torch.rl.apg.train import rollout_loss
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupConfig, PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo.running_statistics import init_state

    c = APG_PENDULUM
    env = PendulumSwingupEnv(PendulumSwingupConfig(physics_steps_per_control_step=2), device=device)
    wrapped = wrappers.wrap_for_training(env, APG_FIRST_EPISODE)
    nets = make_apg_networks(3, 1)
    params = {k: v.to(device).requires_grad_(True) for k, v in nets.policy_network.init(
        torch.Generator().manual_seed(seed)).items()}
    with torch.no_grad():
        state = wrapped.reset(torch.Generator().manual_seed(seed + 1), c["num_envs"])
    loss, _, _ = rollout_loss(wrapped, nets, params, init_state(torch.zeros(3, device=device)), state,
                              APG_FIRST_EPISODE)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads])).item()


def apg_pendulum(device, card: str) -> dict:
    """APG on the pendulum swingup at APG_PENDULUM: finite losses and grad
    norms, exact launches (each update: a reset, then every control step's
    physics twice, forward and the checkpoint's recompute; each eval: a
    reset and one pass), training env-steps/s; and the first update's loss
    and grad norm card vs CPU within APG_FIRST_RTOL. Returns the launches."""
    import math

    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl.apg import train
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupConfig, PendulumSwingupEnv

    c = APG_PENDULUM
    env = PendulumSwingupEnv(PendulumSwingupConfig(physics_steps_per_control_step=2), device=device)
    per_forward, per_step = _per_call_launches(env.model, device)
    marks = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    train(env, device=device, progress_fn=lambda step, m: marks.append((step, m)), **c)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    physics = 2 * c["episode_length"]
    # the observation size's one-env reset, an eval before and after, and per update a reset and two passes
    expected = _expect(per_forward, per_step, 1 + c["num_evals"] + c["policy_updates"],
                       c["num_evals"] * physics + 2 * c["policy_updates"] * physics)
    _check_launches("apg_pendulum", launches, ("cholesky", "cho_solve"), 1, expected)
    last = marks[-1][1]
    for k, v in last.items():
        if not math.isfinite(v):
            fail(f"apg_pendulum: {k} = {v}")
    train_s = last["timing/forward_s"] + last["timing/backward_s"]
    rate = c["policy_updates"] * c["num_envs"] * c["episode_length"] / train_s
    rewards = ", ".join(f"{m['eval/episode_reward']:.1f}" for _, m in marks)
    t0 = time.perf_counter()
    loss_card, norm_card = _apg_first_update(device)
    t1 = time.perf_counter()
    loss_cpu, norm_cpu = _apg_first_update("cpu")
    t2 = time.perf_counter()
    rel_loss, rel_norm = abs(loss_card - loss_cpu) / abs(loss_cpu), abs(norm_card - norm_cpu) / abs(norm_cpu)
    print(f"apg_pendulum: {c['policy_updates']} updates of {c['num_envs']} envs x {c['episode_length']} control steps "
          f"+ {c['num_evals']} evals in {seconds:.3f} s [{card}]; training {rate:.1f} env-steps/s (forward "
          f"{last['timing/forward_s']:.3f} s, backward {last['timing/backward_s']:.3f} s, eval "
          f"{last['timing/eval_s']:.3f} s); eval rewards {rewards}; "
          f"loss {last['training/episode_loss']:.4f}, grad norm {last['training/grad_norm']:.4f}; launches {launches}\n"
          f"apg_pendulum: first update ({APG_FIRST_EPISODE} control steps) card vs CPU: loss {loss_card:.6f} / {loss_cpu:.6f} (rel {rel_loss:.2e}), grad "
          f"norm {norm_card:.6f} / {norm_cpu:.6f} (rel {rel_norm:.2e}; bar {APG_FIRST_RTOL}); {t1 - t0:.1f} s on the "
          f"card, {t2 - t1:.1f} s on the CPU", flush=True)
    if not (rel_loss <= APG_FIRST_RTOL and rel_norm <= APG_FIRST_RTOL):
        fail("apg_pendulum: the first update's loss or grad norm differs between the card and the CPU")
    return launches


def apg_quadruped(device, card: str) -> dict:
    """One APG update of the 4096-env locomotion policy at APG_QUADRUPED,
    kernels 1-4 under the gradient: a finite, nonzero grad norm, moved
    params, exact launches, the update's forward and backward seconds,
    training env-steps/s and peak device memory. Returns the launches."""
    import math

    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl import get_environment
    from ambersim_tpu_torch.rl.apg import make_apg_networks, train
    from ambersim_tpu_torch.rl.ppo import networks

    c = APG_QUADRUPED
    env = get_environment("quadruped_locomotion", device=device)
    physics = env.config.physics_steps_per_control_step * c["episode_length"]
    per_forward, per_step = _per_call_launches(env.model, device)
    initial = {}

    def factory(obs_size, action_size, preprocess_observations_fn):
        nets = make_apg_networks(obs_size, action_size, preprocess_observations_fn=preprocess_observations_fn)

        def init(generator):
            params = nets.policy_network.init(generator)
            initial.update({k: v.clone() for k, v in params.items()})
            return params

        return networks.PPONetworks(networks.FeedForwardNetwork(init=init, apply=nets.policy_network.apply),
                                    nets.value_network, nets.parametric_action_distribution)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    _, (_, params), metrics = train(env, device=device, network_factory=factory, **c)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(LAUNCHES)
    expected = _expect(per_forward, per_step, 3, 3 * physics)  # obs size, update and eval resets; two passes + eval
    _check_launches("apg_quadruped", launches, _LINALG + ("newton_structured",), 1, expected)
    norm = metrics["training/grad_norm"]
    moved = max((params[k] - v).abs().max().item() for k, v in initial.items())
    if not (math.isfinite(norm) and norm > 0 and math.isfinite(metrics["training/episode_loss"]) and moved > 0):
        fail(f"apg_quadruped: grad norm {norm}, loss {metrics['training/episode_loss']}, params moved {moved}")
    fwd, bwd = metrics["timing/forward_s"], metrics["timing/backward_s"]
    print(f"apg_quadruped: one update of {c['num_envs']} envs x {c['episode_length']} control steps ({physics} physics "
          f"steps, each checkpointed control step recomputed) in {seconds:.3f} s with the eval [{card}]: forward "
          f"{fwd:.3f} s, backward {bwd:.3f} s, training {c['num_envs'] * c['episode_length'] / (fwd + bwd):.1f} "
          f"env-steps/s; loss {metrics['training/episode_loss']:.4f}, grad norm {norm:.4f}, params moved by up to "
          f"{moved:.3e}; peak device memory {peak:.3f} GiB ({peak - held:.3f} above what was held); launches "
          f"{launches}", flush=True)
    return launches


def _pendulum_ilqr(m, device):
    import torch

    from ambersim_tpu_torch.trajopt import ILQR

    c = ILQR_PENDULUM
    goal = torch.tensor([c["goal"], 0.0], device=device)

    def running(x, u):
        return 0.02 * (u @ u)

    def terminal(x):
        dx = x - goal
        return 100.0 * (dx @ dx)

    return ILQR(model=m, running_cost=running, terminal_cost=terminal, iterations=c["iterations"])


def ilqr_pendulum(device, card: str) -> tuple:
    """examples/trajopt/ex_ilqr.py task 1 on the card (ILQR_PENDULUM): the
    cost at most the guess's, the final angle within the JAX package's
    distance to the goal plus ILQR_ANGLE_SLACK, exact launches (the guess's
    rollout, then per iteration the linearization's one step of N x 2 nv
    envs and the line search's N steps of all step sizes), ms per
    iteration. Returns the launches and the ms per iteration."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import ILQRParams, shoot

    c = ILQR_PENDULUM
    m = load_model("pendulum", device=device)
    per_forward, per_step = _per_call_launches(m, device)
    opt = _pendulum_ilqr(m, device)
    params = ILQRParams(x0=torch.zeros(2, device=device), us_guess=torch.zeros(c["knots"], 1, device=device))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xs, us = opt.optimize(params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    N, I = c["knots"], c["iterations"]
    _check_launches("ilqr_pendulum", launches, ("cholesky", "cho_solve"), 1,
                    _expect(per_forward, per_step, 1, N + I * (1 + N)))
    with torch.no_grad():
        c_guess = opt._traj_cost(shoot(m, params.x0, params.us_guess), params.us_guess).item()
    c_star = opt._traj_cost(xs, us).item()
    angle = xs[-1, 0].item()
    bar = abs(JAX_ILQR_PENDULUM_ANGLE - c["goal"]) + ILQR_ANGLE_SLACK
    print(f"ilqr_pendulum: {N} knots x {I} iterations in {seconds:.3f} s = {1e3 * seconds / I:.1f} ms per iteration "
          f"[{card}]; cost {c_guess:.4f} -> {c_star:.4f}; final angle {angle:.6f} (goal {c['goal']}, JAX package "
          f"{JAX_ILQR_PENDULUM_ANGLE}; |error| bar {bar:.4f}); launches {launches}", flush=True)
    if not (torch.isfinite(xs).all() and c_star <= c_guess and abs(angle - c["goal"]) <= bar):
        fail(f"ilqr_pendulum: cost {c_star} (guess {c_guess}) or final angle {angle} off")
    return launches, 1e3 * seconds / I


def _ilqr_single(angle: float):
    """ILQR_PENDULUM's single-problem solve on the card from `angle` at
    rest, in a process of its own (ilqr_pendulum_batch's pool): (xs, us) on
    the CPU."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine.forward import full_f32_matmul
    from ambersim_tpu_torch.ops import _build
    from ambersim_tpu_torch.trajopt import ILQRParams

    _build.library()
    device = torch.device("cuda", 0)
    with full_f32_matmul():
        m = load_model("pendulum", device=device)
        guess = torch.zeros(ILQR_PENDULUM["knots"], 1, device=device)
        xs, us = _pendulum_ilqr(m, device).optimize(ILQRParams(x0=torch.tensor([angle, 0.0], device=device),
                                                               us_guess=guess))
    return xs.cpu(), us.cpu()


def ilqr_pendulum_batch(device, card: str, single_ms: float) -> dict:
    """ILQR_PENDULUM over ILQR_BATCH_STARTS as one batch of problems
    (ILQR.optimize with x0 (4, 2)): every problem no worse than its guess,
    each within ILQR_BATCH_TOLS of the card's single-problem solve from its
    start, exact launches (the guesses' rollout, then per iteration one step
    of 4 x N x 2 nv envs and N steps of 4 x 6 envs), ms per iteration. The
    four single solves run at once, one spawned process each (each step is
    host-bound: one process would take four times as long); `single_ms`,
    ilqr_pendulum's ms per iteration (the same options, in this process),
    is printed beside the batch's. Returns the batch's launches."""
    import torch

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import ILQRParams, shoot

    c = ILQR_PENDULUM
    N, I, P = c["knots"], c["iterations"], len(ILQR_BATCH_STARTS)
    m = load_model("pendulum", device=device)
    per_forward, per_step = _per_call_launches(m, device)
    opt = _pendulum_ilqr(m, device)
    x0 = torch.tensor([[a, 0.0] for a in ILQR_BATCH_STARTS], device=device)
    guess = torch.zeros(P, N, 1, device=device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xs, us = opt.optimize(ILQRParams(x0=x0, us_guess=guess))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check_launches("ilqr_pendulum_batch", launches, ("cholesky", "cho_solve"), 1,
                    _expect(per_forward, per_step, 1, N + I * (1 + N)))
    import multiprocessing

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(P) as pool:
        single = pool.map(_ilqr_single, ILQR_BATCH_STARTS)
    single_s = time.perf_counter() - t0
    with torch.no_grad():
        c_guess = opt._traj_cost(shoot(m, x0, guess), guess)
    c_star = opt._traj_cost(xs, us)
    dx = max((xs[i].cpu() - single[i][0]).abs().max().item() for i in range(P))
    du = max((us[i].cpu() - single[i][1]).abs().max().item() for i in range(P))
    print(f"ilqr_pendulum_batch: {P} problems x {N} knots x {I} iterations in {seconds:.3f} s = "
          f"{1e3 * seconds / I:.1f} ms per iteration, a single problem {single_ms:.1f} ms per iteration "
          f"(ilqr_pendulum) [{card}]; the {P} single solves in {P} processes {single_s:.1f} s; costs "
          f"{[round(v, 4) for v in c_guess.tolist()]} -> {[round(v, 4) for v in c_star.tolist()]}; "
          f"against the single solves max |dxs| {dx:.3e} (<= {ILQR_BATCH_TOLS[0]}), max |dus| {du:.3e} "
          f"(<= {ILQR_BATCH_TOLS[1]}); launches {launches}", flush=True)
    if not (torch.isfinite(xs).all() and bool((c_star <= c_guess).all())):
        fail(f"ilqr_pendulum_batch: a problem's cost {c_star.tolist()} over its guess's {c_guess.tolist()}")
    if not (dx <= ILQR_BATCH_TOLS[0] and du <= ILQR_BATCH_TOLS[1]):
        fail("ilqr_pendulum_batch: a problem parts from its single-problem solve")
    return launches


def hand_gradient_trajopt(device, card: str) -> dict:
    """The hand at BASELINE.md:13's 10 knots, hand_sampling's cost, start
    and guess: GradientShootingOptimizer (HAND_GRADIENT_ITERS Adam steps
    through the step) and ILQR (HAND_ILQR_ITERS iterations, the cost split
    into its running and terminal terms), one optimize call each, timed;
    each must cost at most the guess; exact launches. Returns the launches
    of both calls."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import ILQR, GradientShootingOptimizer, ILQRParams, ShootingParams, shoot

    m = hand_model(device)
    cost = hand_cost(device)
    per_forward, per_step = _per_call_launches(m, device)
    x0 = torch.cat([hand_start(m, 1, seed=10, scale=0.3)[0], torch.zeros(m.skel.nv, device=device)])
    guess = torch.as_tensor(0.3 * np.random.default_rng(11).standard_normal((HAND_HORIZON, m.skel.nu)).astype(
        np.float32), device=device)
    with torch.no_grad():
        c_guess = cost.cost(shoot(m, x0, guess), guess).item()

    def running(x, u):
        dx = x - cost.xg
        return dx @ cost.Q @ dx + u @ cost.R @ u

    def terminal(x):
        dx = x - cost.xg
        return dx @ cost.Qf @ dx

    H, G, I = HAND_HORIZON, HAND_GRADIENT_ITERS, HAND_ILQR_ITERS
    runs = {
        "gradient": (GradientShootingOptimizer(model=m, cost_function=cost, iters=G, learning_rate=0.05),
                     ShootingParams(x0=x0, us_guess=guess), _expect(per_forward, per_step, G + 2, H * (G + 2))),
        "ilqr": (ILQR(model=m, running_cost=running, terminal_cost=terminal, iterations=I),
                 ILQRParams(x0=x0, us_guess=guess), _expect(per_forward, per_step, 1, H + I * (1 + H))),
    }
    launches = {k: 0 for k in LAUNCHES}
    for name, (opt, params, expected) in runs.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        xs, us = opt.optimize(params)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _check_launches(f"hand_gradient_trajopt {name}", dict(LAUNCHES), _HAND_KERNELS, 1, expected)
        launches = {k: launches[k] + LAUNCHES[k] for k in launches}
        c_star = cost.cost(xs, us).item()
        print(f"hand_gradient_trajopt {name}: one optimize call of {H} knots in {1e3 * seconds:.1f} ms [{card}]; cost "
              f"{c_guess:.6f} -> {c_star:.6f}; launches {dict(LAUNCHES)}", flush=True)
        if not (torch.isfinite(xs).all() and c_star <= c_guess + 1e-5 + 1e-5 * abs(c_guess)):
            fail(f"hand_gradient_trajopt {name}: the result costs {c_star:.6f}, the guess {c_guess:.6f}")
    return launches


# ---- 9. ES, ARS and SAC: the gradient-free and off-policy trainers ----


def _with_defaults(train, c: dict) -> dict:
    """`c` over `train`'s own defaults."""
    import inspect

    return {**{k: p.default for k, p in inspect.signature(train).parameters.items()
               if p.default is not inspect.Parameter.empty}, **c}


def _evals_and_epochs(c: dict) -> tuple[int, int]:
    """(evals, epochs) of a trainer at `c`: an initial eval when num_evals > 1,
    then one eval after each of max(num_evals - 1, 1) epochs."""
    epochs = max(c["num_evals"] - 1, 1)
    return epochs + (c["num_evals"] > 1), epochs


def _check_actions(name: str, make_policy, params, device) -> None:
    """The returned policy's actions lie in [-1, 1], deterministic and
    sampled, on obs of 10 N(0, 1)."""
    import torch

    normalizer = params[0]
    obs = 10 * torch.randn((256, normalizer.mean.shape[0]), generator=torch.Generator(device).manual_seed(0),
                           device=device)
    for deterministic in (True, False):
        act, _ = make_policy(params, deterministic=deterministic)(obs, torch.Generator(device).manual_seed(1))
        if not (torch.isfinite(act).all() and bool((act.abs() <= 1.0).all())):
            fail(f"{name}: the policy's actions leave [-1, 1] (deterministic {deterministic})")


def _check_metrics(name: str, metrics: dict) -> None:
    import math

    for k, v in metrics.items():
        if not math.isfinite(v):
            fail(f"{name}: {k} = {v}")


def gradient_free_phase(name: str, kind: str, env, c: dict, device, card: str) -> dict:
    """ES or ARS (`kind`) on `env` at the settings `c`, with the launch
    counts set to 0 just before and read just after: exact launches (one
    reset for the observation size; per update a reset of the population
    and every control step's physics; per eval a reset and one pass),
    finite metrics, actions in [-1, 1]; prints training env-steps/s and the
    timing split. Returns the launches."""
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl import ars, es

    train = {"es": es.train, "ars": ars.train}[kind]
    settings, c = c, _with_defaults(train, c)
    members = c["population_size"] if kind == "es" else 2 * c["number_of_directions"]
    physics = env.config.physics_steps_per_control_step * c["episode_length"]
    evals, epochs = _evals_and_epochs(c)
    updates = epochs * -(-c["policy_updates"] // epochs)
    per_forward, per_step = _per_call_launches(env.model, device)
    marks = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    make_policy, params, metrics = train(env, device=device, progress_fn=lambda step, m: marks.append((step, m)),
                                         **settings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    expected = _expect(per_forward, per_step, 1 + updates + evals, (updates + evals) * physics)
    _check_launches(name, launches, tuple(k for k, n in expected.items() if n), 1, expected)
    _check_metrics(name, metrics)
    _check_actions(name, make_policy, params, device)
    if marks[-1][0] != updates * members * c["episode_length"]:
        fail(f"{name}: {marks[-1][0]} env steps reported, want {updates * members * c['episode_length']}")
    rollout_s, update_s, eval_s = metrics["timing/rollout_s"], metrics["timing/update_s"], metrics["timing/eval_s"]
    rewards = ", ".join(f"{m['eval/episode_reward']:.1f}" for _, m in marks)
    print(f"{name}: {updates} updates of {members} members x {c['episode_length']} control steps ({physics} physics "
          f"steps each) + {evals} evals of {c['num_eval_envs']} envs in {seconds:.3f} s [{card}]; training "
          f"{updates * members * c['episode_length'] / (rollout_s + update_s):.1f} env-steps/s; rollout "
          f"{rollout_s:.3f} s, update {update_s:.3f} s, eval {eval_s:.3f} s; eval rewards {rewards}; "
          + ", ".join(f"{k[len('training/'):]} {v:.4f}" for k, v in metrics.items() if k.startswith("training/"))
          + f"; launches {launches}", flush=True)
    return launches


def _population_first(kind: str, c: dict, device, returns=None):
    """The first update of ES or ARS (`kind`) at `c`'s width on the pendulum,
    its rollout cut to POPULATION_FIRST_EPISODE control steps: params, noise
    and starts from CPU generators, so both devices start from the same bits.
    The update is computed from `returns` (the CPU's (shifted, raw)
    returns) when given, else from the rollout's own. Returns the
    rollout's (shifted, raw) returns and the updated params, on the CPU."""
    import torch

    from ambersim_tpu_torch.rl import ars, es, wrappers
    from ambersim_tpu_torch.rl.apg.train import make_deterministic_networks
    from ambersim_tpu_torch.rl.ars.train import TrainingState, ars_update, candidates, draw_directions
    from ambersim_tpu_torch.rl.es.train import es_update, make_training_state, mirrored_noise, population_rollout
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupConfig, PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo import running_statistics
    from ambersim_tpu_torch.rl.ppo.networks import identity_observation_preprocessor

    c = _with_defaults({"es": es.train, "ars": ars.train}[kind], c)
    env = PendulumSwingupEnv(PendulumSwingupConfig(physics_steps_per_control_step=2), device=device)
    wrapped = wrappers.wrap_for_training(env, POPULATION_FIRST_EPISODE)
    normalize = c["normalize_observations"]
    nets = make_deterministic_networks(3, 1, preprocess_observations_fn=running_statistics.normalize if normalize
                                       else identity_observation_preprocessor)
    cpu = torch.Generator().manual_seed(c["seed"])
    params = {k: v.to(device) for k, v in nets.policy_network.init(cpu).items()}
    norm = running_statistics.init_state(torch.zeros(3, device=device))
    if kind == "es":
        members = c["population_size"]
        noise = mirrored_noise(cpu, params, members)
        pop = {k: p[None] + c["perturbation_std"] * noise[k] for k, p in params.items()}
    else:
        members = 2 * c["number_of_directions"]
        noise = draw_directions(cpu, params, c["number_of_directions"])
        pop = candidates(params, noise, c["exploration_noise_std"])
    with torch.no_grad():
        state = wrapped.reset(cpu, members)
    total, raw, obs = population_rollout(wrapped, nets, pop, norm, state, POPULATION_FIRST_EPISODE,
                                         c.get("reward_shift", 0.0))
    r, r_raw = (total, raw) if returns is None else (x.to(device) for x in returns)
    if kind == "es":
        ts = make_training_state(params, norm, c["learning_rate"])
        es_update(ts, noise, r, obs, c["perturbation_std"], c["l2coeff"], normalize_observations=normalize)
    else:
        ts = TrainingState(policy_params=params, normalizer_params=norm)
        ars_update(ts, noise, r, r_raw, obs, c["top_directions"], c["step_size"], normalize)
    return (total.cpu(), raw.cpu()), {k: v.cpu() for k, v in ts.policy_params.items()}


def population_card_vs_cpu(name: str, kind: str, c: dict, device) -> None:
    """ES's or ARS's first update, card against CPU (_population_first): the
    population's mean return within APG_FIRST_RTOL, with the share of
    members within it printed; then the update from the CPU's returns and
    the same noise on both devices within POPULATION_UPDATE_RTOL of each
    leaf's largest |param| (pure arithmetic: a rank swap cannot hide in
    it)."""
    returns_cpu, after_cpu = _population_first(kind, c, "cpu")
    (total, _), after_card = _population_first(kind, c, device, returns=returns_cpu)
    total_cpu = returns_cpu[0]
    rel = abs(total.mean().item() - total_cpu.mean().item()) / abs(total_cpu.mean().item())
    share = ((total - total_cpu).abs() <= APG_FIRST_RTOL * total_cpu.abs()).float().mean().item()
    upd = max(((after_card[k] - v).abs().max() / v.abs().max()).item() for k, v in after_cpu.items())
    print(f"{name}: first update ({total.shape[0]} members x {POPULATION_FIRST_EPISODE} control steps) card vs "
          f"CPU: mean return {total.mean().item():.4f} / {total_cpu.mean().item():.4f} (rel {rel:.2e}, bar {APG_FIRST_RTOL}); "
          f"{share:.4f} of members within {APG_FIRST_RTOL}; the update from the CPU's returns, card vs CPU: "
          f"{upd:.2e} of each leaf's largest |param| (bar {POPULATION_UPDATE_RTOL})", flush=True)
    if not rel <= APG_FIRST_RTOL:
        fail(f"{name}: the first update's mean return differs between the card and the CPU by {rel:.2e}")
    if not upd <= POPULATION_UPDATE_RTOL:
        fail(f"{name}: the update from the same returns and noise differs between the card and the CPU by {upd:.2e}")


def sac_phase(name: str, env, c: dict, device, card: str) -> dict:
    """SAC on `env` at the settings `c`, with the launch counts set to 0 just
    before and read just after: exact launches (one reset for the
    observation size, one for the envs, every actor step's physics of the
    prefill and the training steps, and per eval a reset and one pass),
    finite metrics, actions in [-1, 1], the normalizer's count; prints
    training env-steps/s, SGD steps/s, the timing split and the peak device
    memory (the replay buffer lives on the card). Returns the launches."""
    import torch

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl import sac

    settings, c = c, _with_defaults(sac.train, c)
    control = env.config.physics_steps_per_control_step
    evals, epochs = _evals_and_epochs(c)
    prefill = max(-(-c["min_replay_size"] // c["num_envs"]), 1)
    steps = epochs * max(1, -(-(c["num_timesteps"] - prefill * c["num_envs"]) // (c["num_envs"] * epochs)))
    per_forward, per_step = _per_call_launches(env.model, device)
    marks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    make_policy, params, metrics = sac.train(env, device=device, progress_fn=lambda step, m: marks.append((step, m)),
                                             **settings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(LAUNCHES)
    expected = _expect(per_forward, per_step, 2 + evals, control * (prefill + steps + evals * c["episode_length"]))
    _check_launches(name, launches, tuple(k for k, n in expected.items() if n), 1, expected)
    _check_metrics(name, metrics)
    _check_actions(name, make_policy, params, device)
    env_steps = (prefill + steps) * c["num_envs"]
    if marks[-1][0] != env_steps or (c["normalize_observations"] and float(params[0].count) != env_steps):
        fail(f"{name}: {marks[-1][0]} env steps reported, normalizer count {float(params[0].count)}, want {env_steps}")
    actor_s, sgd_s, eval_s = metrics["timing/actor_s"], metrics["timing/sgd_s"], metrics["timing/eval_s"]
    obs_size, act_size = params[0].mean.shape[0], env.action_size
    buffer_gib = c["max_replay_size"] * (2 * obs_size + act_size + 3) * 4 / 2**30
    rewards = ", ".join(f"{m['eval/episode_reward']:.1f}" for _, m in marks)
    print(f"{name}: {c['num_envs']} envs, prefill {prefill} + {steps} training steps x {control} physics steps, "
          f"{steps * c['grad_updates_per_step']} SGD steps of batch {c['batch_size']}, + {evals} evals of "
          f"{c['num_eval_envs']} envs in {seconds:.3f} s [{card}]; training "
          f"{steps * c['num_envs'] / (actor_s + sgd_s):.1f} env-steps/s, "
          f"{steps * c['grad_updates_per_step'] / sgd_s:.1f} SGD steps/s; prefill {metrics['timing/prefill_s']:.3f} "
          f"s, actor {actor_s:.3f} s, SGD {sgd_s:.3f} s, eval {eval_s:.3f} s; replay buffer of "
          f"{c['max_replay_size']} transitions {buffer_gib:.3f} GiB; peak device memory {peak:.3f} GiB "
          f"({peak - held:.3f} above what was held); eval rewards {rewards}; "
          + ", ".join(f"{k[len('training/'):]} {v:.4f}" for k, v in metrics.items() if k.startswith("training/"))
          + f"; launches {launches}", flush=True)
    return launches


def _sac_first_sgd(c: dict, device, dtype=None):
    """SAC_FIRST_SGD SGD steps at `c`'s settings on the pendulum's shapes
    from params, a replay buffer of min_replay_size seeded transitions, a
    normalizer fitted to them, sample indices and normals, all drawn by CPU
    generators (in float32; the steps run in `dtype`, float32 unless
    given). Returns each step's (critic, actor, alpha) losses and alpha,
    and the params after, on the CPU."""
    import torch

    from ambersim_tpu_torch.rl import sac
    from ambersim_tpu_torch.rl.ppo import running_statistics
    from ambersim_tpu_torch.rl.sac import replay
    from ambersim_tpu_torch.rl.sac.losses import Transition
    from ambersim_tpu_torch.rl.sac.train import make_training_state, sgd_step

    c = _with_defaults(sac.train, c)
    n, batch = c["min_replay_size"], c["batch_size"]
    cpu = torch.Generator().manual_seed(c["seed"])
    nets = sac.make_sac_networks(3, 1, preprocess_observations_fn=running_statistics.normalize)
    policy, q = nets.policy_network.init(cpu), nets.q_network.init(cpu)
    scale = torch.tensor([1.0, 1.0, 4.0])
    truncation = (torch.rand(n, generator=cpu) < 0.01).float()
    data = Transition(observation=scale * torch.randn((n, 3), generator=cpu),
                      action=torch.randn((n, 1), generator=cpu), reward=-10 * torch.rand(n, generator=cpu),
                      discount=1 - truncation, truncation=truncation,
                      next_observation=scale * torch.randn((n, 3), generator=cpu))
    norm = running_statistics.update(running_statistics.init_state(torch.zeros(3)), data.observation)
    idx = torch.randint(0, n, (SAC_FIRST_SGD, batch), generator=cpu)
    noise = torch.randn((SAC_FIRST_SGD, 3, batch, 1), generator=cpu)
    dtype = dtype or torch.float32
    ts = make_training_state({k: v.to(device, dtype) for k, v in policy.items()},
                             {k: v.to(device, dtype) for k, v in q.items()}, torch.zeros((), device=device, dtype=dtype),
                             norm.to(device).to(dtype), c["learning_rate"])
    data = data.to(device).to(dtype)
    buffer = replay.insert(replay.init(n, data.map(lambda x: x[0])), data)
    losses = []
    for i in range(SAC_FIRST_SGD):
        m = sgd_step(ts, replay.sample(buffer, idx[i]), noise[i].to(device, dtype), nets, target_entropy=-0.5,
                     reward_scaling=c["reward_scaling"], discounting=c["discounting"], tau=c["tau"])
        losses.append(torch.stack([m[k] for k in ("critic_loss", "actor_loss", "alpha_loss", "alpha")]))
    after = {f"{net} {k}": v.detach().cpu() for net in ("policy_params", "q_params", "target_q_params")
             for k, v in getattr(ts, net).items()}
    after["log_alpha"] = ts.log_alpha.detach().cpu()
    return torch.stack(losses).cpu(), after


def sac_card_vs_cpu(name: str, c: dict, device) -> None:
    """SAC's first SAC_FIRST_SGD SGD steps, card against CPU
    (_sac_first_sgd): every loss within SAC_LOSS_RTOL, every param within
    rtol 1e-4 and atol 1e-3 x the learning rate of the CPU's; where one is
    not, each leaf within that atol of as close to the float64 steps as the
    CPU's float32 (the comment above POPULATION_FIRST_EPISODE)."""
    import torch

    losses_card, card = _sac_first_sgd(c, device)
    losses_cpu, cpu = _sac_first_sgd(c, "cpu")
    rel = ((losses_card - losses_cpu).abs() / losses_cpu.abs()).max().item()
    atol = 1e-3 * c["learning_rate"]
    excess = {k: ((card[k] - v).abs() - 1e-4 * v.abs()).max().item() for k, v in cpu.items()}
    worst = max(excess, key=excess.get)
    apart = {k: ((card[k] - v).abs() > 1e-4 * v.abs() + atol).sum().item() for k, v in cpu.items()}
    print(f"{name}: first {SAC_FIRST_SGD} SGD steps card vs CPU: losses within {rel:.2e} relative (bar "
          f"{SAC_LOSS_RTOL}); params: largest |card - CPU| - 1e-4 |CPU| {excess[worst]:.2e} at {worst} (bar "
          f"{atol:.1e}); {sum(apart.values())} of {sum(v.numel() for v in cpu.values())} params past it", flush=True)
    if not rel <= SAC_LOSS_RTOL:
        fail(f"{name}: the first SGD steps' losses differ between the card and the CPU by {rel:.2e}")
    if excess[worst] <= atol:
        return
    _, exact = _sac_first_sgd(c, "cpu", torch.float64)
    farther = {k: ((card[k] - exact[k]).abs().max() - (v - exact[k]).abs().max()).item() for k, v in cpu.items()}
    far = max(farther, key=farther.get)
    print(f"{name}: against the float64 steps: the card's farthest param exceeds the CPU float32's farthest in its "
          f"leaf by at most {farther[far]:.2e} ({far}; bar {atol:.1e}); " + ", ".join(
              f"{k} card {(card[k] - exact[k]).abs().max().item():.2e} / CPU {(cpu[k] - exact[k]).abs().max().item():.2e}"
              for k in cpu if apart[k]), flush=True)
    if not farther[far] <= atol:
        fail(f"{name}: {far} after the first SGD steps is farther from float64 on the card than on the CPU")


def gradient_free_and_off_policy(device, card: str, lap) -> dict:
    """Section 9: ES, ARS and SAC on the pendulum at
    examples/rl/pendulum/ex_agents.py's settings (cut), each with its card
    against CPU check, then ES at population 512 and SAC with a 1,000,000
    transition replay on quadruped_locomotion. Returns the launches by
    phase."""
    from ambersim_tpu_torch.rl import get_environment
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupConfig, PendulumSwingupEnv

    pendulum = PendulumSwingupEnv(PendulumSwingupConfig(physics_steps_per_control_step=2), device=device)
    quadruped = get_environment("quadruped_locomotion", device=device)
    phases = {}
    phases["es_pendulum"] = gradient_free_phase("es_pendulum", "es", pendulum, ES_PENDULUM, device, card)
    population_card_vs_cpu("es_pendulum", "es", ES_PENDULUM, device)
    lap("es_pendulum")
    phases["ars_pendulum"] = gradient_free_phase("ars_pendulum", "ars", pendulum, ARS_PENDULUM, device, card)
    population_card_vs_cpu("ars_pendulum", "ars", ARS_PENDULUM, device)
    lap("ars_pendulum")
    phases["sac_pendulum"] = sac_phase("sac_pendulum", pendulum, SAC_PENDULUM, device, card)
    sac_card_vs_cpu("sac_pendulum", SAC_PENDULUM, device)
    lap("sac_pendulum")
    phases["es_quadruped"] = gradient_free_phase("es_quadruped", "es", quadruped, ES_QUADRUPED, device, card)
    lap("es_quadruped")
    phases["sac_quadruped"] = sac_phase("sac_quadruped", quadruped, SAC_QUADRUPED, device, card)
    lap("sac_quadruped")
    return phases


def env_card_vs_cpu(device, name: str, env_cls, control_steps: int, obs_bars, reset=None) -> None:
    """An env, 8 envs x `control_steps` control steps with the same actions
    on the card (kernels) and on the CPU (plain versions), from the env's
    reset or `reset`(env, generator, 8): obs within the card-vs-CPU bars by
    column (obs_bars: qpos-derived columns at QPOS_TOL, qvel-derived ones at
    QVEL_TOL, the last action exact), reward within QVEL_TOL, done equal."""
    import numpy as np
    import torch

    runs = []
    for dev in (device, "cpu"):
        env = env_cls(device=dev)
        actions = np.random.default_rng(0).uniform(-1.0, 1.0, (control_steps, 8, env.action_size)).astype(np.float32)
        generator = torch.Generator().manual_seed(0)  # a CPU generator: the same starts on both
        s = reset(env, generator, 8) if reset else env.reset(generator, 8)
        out = []
        for a in actions:
            s = env.step(s, torch.as_tensor(a, device=dev))
            out.append((s.obs.cpu(), s.reward.cpu(), s.done.cpu()))
        runs.append(out)
    worst = {"obs": 0.0, "reward": 0.0}
    for t, ((obs_g, rew_g, done_g), (obs_c, rew_c, done_c)) in enumerate(zip(*runs)):
        for cols, tol in obs_bars:
            err = (obs_g[:, cols] - obs_c[:, cols]).abs().max().item()
            worst["obs"] = max(worst["obs"], err)
            if not err <= tol:
                fail(f"env_card_vs_cpu {name}: obs[{cols.start}:{cols.stop}] at control step {t} differs by "
                     f"{err:.3e} > {tol}")
        err = (rew_g - rew_c).abs().max().item()
        worst["reward"] = max(worst["reward"], err)
        if not err <= QVEL_TOL:
            fail(f"env_card_vs_cpu {name}: reward at control step {t} differs by {err:.3e} > {QVEL_TOL}")
        if not torch.equal(done_g, done_c):
            fail(f"env_card_vs_cpu {name}: done at control step {t} differs")
    print(f"env_card_vs_cpu: {name} env 8 envs x {control_steps} control steps: max |dobs| {worst['obs']:.3e}, "
          f"max |dreward| {worst['reward']:.3e}, done equal", flush=True)


def ray_card_vs_cpu(device, card: str) -> None:
    """engine.ray.ray on the card against the CPU: RAY_RIG (every geom type
    and a convex mesh; compiled by the port) at RAY_ENVS seeded poses of its
    hinges, one ray an env (half aimed at a geom, half in any direction),
    and the terrain scene at NUM_ENVS quadrupeds spread over the field,
    TERRAIN_RAYS downward rays an env from 1 m about its trunk. Distances
    within RAY_TOL where both hit, the same geom ids, misses (-1, -1) on
    both; every geom of the rig hit, and every terrain ray. Prints rays/s
    on the card over RAY_REPS passes after the compared one."""
    import tempfile

    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data, smooth
    from ambersim_tpu_torch.engine.ray import ray
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.io.bridge import model_from_numpy
    from ambersim_tpu_torch.mjcf import compile_spec_arrays, parse_mjcf_string

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "octa.obj").write_text(OCTA_OBJ)
        skel, leaves = compile_spec_arrays(parse_mjcf_string(RAY_RIG, base_dir=tmp))
    leaves = set_constants(skel, leaves)
    rng = np.random.default_rng(7)
    B = RAY_ENVS
    rig_qpos = rng.uniform(-1.2, 1.2, (B, skel["nq"]))
    pnt = np.concatenate([rng.uniform(-2, 2, (B, 2)), rng.uniform(0.2, 2, (B, 1))], -1)
    targets = np.array([[0, 0, 1], [1.2, 0, 1], [0, 1.2, 1], [-1.2, 0, 1], [0, -1.2, 1], [1.2, 1.2, 1], [-1.2, 1.2, 1],
                        [0, 0, 0]])
    vec = unit(targets[rng.integers(0, len(targets), B)] + 0.1 * rng.standard_normal((B, 3)) - pnt)
    vec[B // 2:] = unit(rng.standard_normal((B - B // 2, 3)))
    cases = [("rig", lambda dev: model_from_numpy(skel, leaves, device=dev), rig_qpos, [(pnt, vec)])]
    m = terrain_env("cpu").model
    tq = np.tile(m.qpos0.numpy(), (NUM_ENVS, 1))
    tq[:, :2] += np.random.default_rng(14).uniform(-5.0, 5.0, (NUM_ENVS, 2))
    offsets = np.stack(np.meshgrid(np.linspace(-0.3, 0.3, 3), np.linspace(-0.3, 0.3, 3)), -1).reshape(-1, 2)
    down = np.tile([0.0, 0.0, -1.0], (NUM_ENVS, 1))
    rays = [(np.concatenate([tq[:, :2] + o, np.ones((NUM_ENVS, 1))], -1), down) for o in offsets[:TERRAIN_RAYS]]
    cases.append(("terrain", lambda dev: terrain_env(dev).model, tq, rays))
    for what, build, qpos, casts in cases:
        out, seconds = {}, 0.0
        for on_card, dev in ((True, device), (False, "cpu")):
            m = build(dev)
            d = smooth.kinematics(m, make_data(m, len(qpos)).replace(
                qpos=torch.as_tensor(qpos, dtype=torch.float32, device=dev)))
            on_dev = [tuple(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in c) for c in casts]
            out[on_card] = [tuple(x.cpu() for x in ray(m, d, p, v)) for p, v in on_dev]
            if on_card:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(RAY_REPS):
                    for p, v in on_dev:
                        ray(m, d, p, v)
                torch.cuda.synchronize()
                seconds = (time.perf_counter() - t0) / RAY_REPS
        n, worst, hit = 0, 0.0, set()
        for (tg, gg), (tc, gc) in zip(out[True], out[False]):
            if not torch.equal(gg, gc):
                fail(f"ray {what}: the card and the CPU hit other geoms on {(gg != gc).sum().item()} rays")
            both = gc >= 0
            if not (bool((tg[~both] == -1).all()) and bool((tc[~both] == -1).all())):
                fail(f"ray {what}: a miss is not (-1, -1)")
            worst = max(worst, (tg[both] - tc[both]).abs().max().item() if both.any() else 0.0)
            n += int(both.sum())
            hit |= set(gc[both].tolist())
        if not worst <= RAY_TOL:
            fail(f"ray {what}: distances differ by {worst:.3e} > {RAY_TOL}")
        rays = len(casts) * len(qpos)
        if what == "rig" and hit != set(range(skel["ngeom"])):
            fail(f"ray rig: geoms {sorted(set(range(skel['ngeom'])) - hit)} never hit")
        if what == "terrain" and n != rays:
            fail(f"ray terrain: {rays - n} of {rays} downward rays missed")
        print(f"ray {what}: {len(casts)} x {len(qpos)} rays, {n} hits on geoms {sorted(hit)}; card vs CPU max "
              f"|ddist| {worst:.3e} (<= {RAY_TOL}), geom ids equal; {rays / seconds:.1f} rays/s on the card "
              f"({1e3 * seconds / len(casts):.3f} ms a call of {len(qpos)} rays, {RAY_REPS} passes) [{card}]", flush=True)


def compile_asset(name: str, device):
    """The committed asset `name` compiled from its MJCF on this machine by
    the port's loader, with the exporter's options. The row cap is the
    max_contact_points custom numeric spliced into the XML through
    parse_mjcf_string, as benchmarks/ladder.py:133-142 does."""
    import os

    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.io.bridge import model_from_numpy
    from ambersim_tpu_torch.mjcf import compile_spec_arrays, parse_mjcf_string
    from ambersim_tpu_torch.utils._internal_utils import _check_filepath
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    xml, cone, cap, rows = COMPILED_ASSETS[name]
    if not rows:
        return load_model_from_file(xml, cone=cone, broadphase_cap=cap, device=device)
    path = _check_filepath(xml)
    text = Path(path).read_text().replace(
        "</mujoco>", f'<custom><numeric name="max_contact_points" data="{rows}"/></custom></mujoco>')
    spec = parse_mjcf_string(text, base_dir=os.path.dirname(path))
    skel_fields, leaves = compile_spec_arrays(spec, broadphase_cap=cap)
    return model_from_numpy(skel_fields, set_constants(skel_fields, leaves), device=device)


def model_numpy(m) -> tuple[dict, dict]:
    """(skel_fields, leaves) of a port Model as numpy, under the exported
    model files' names (io/bridge.py)."""
    import dataclasses

    import numpy as np
    import torch

    leaves = {f.name: getattr(m, f.name).cpu().numpy() for f in dataclasses.fields(m) if f.name not in ("skel", "opt")}
    for f in dataclasses.fields(m.opt):
        v = getattr(m.opt, f.name)
        leaves["opt." + f.name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return dict(m.skel._fields), leaves


def mesh_canonical(skel: dict, leaves: dict, i: int, decimals: int = 4) -> tuple:
    """Mesh i's hull with qhull's order taken out: its vertices, its faces
    (normal, offset, vertex count, centroid) and its edges (endpoints in
    order), each as rows sorted by their values rounded to `decimals`."""
    import numpy as np

    def rows_sorted(a):
        a = a.reshape(len(a), -1).astype(np.float64)
        return a[np.lexsort(np.round(a, decimals).T[::-1])]

    nv, nf, ne = int(skel["mesh_vertnum"][i]), int(skel["mesh_facenum"][i]), int(skel["mesh_edgenum"][i])
    nvert = skel["mesh_face_nvert"][i, :nf]
    ring = leaves["mesh_face_vert"][i, :nf]
    centroid = np.stack([ring[f, : nvert[f]].mean(0) for f in range(nf)]) if nf else np.zeros((0, 3))
    faces = np.concatenate([leaves["mesh_face_normal"][i, :nf], leaves["mesh_face_dist"][i, :nf, None],
                            nvert[:, None], centroid], 1)
    edges = leaves["mesh_edge"][i, :ne].astype(np.float64)
    swap = np.lexsort(np.round(edges, decimals).transpose(2, 0, 1)[::-1])  # (ne, 2): each edge's endpoint order
    edges = np.take_along_axis(edges, swap[:, :, None], 1)
    return rows_sorted(leaves["mesh_vert"][i, :nv]), rows_sorted(faces), rows_sorted(edges)


def setconst_rtol(skel_fields: dict, leaves: dict) -> float:
    """The setconst fields' bar: cond(qM at qpos0) x float32's unit roundoff,
    at least 1e-6 (qM from the port's smooth pass on the CPU)."""
    import numpy as np

    from ambersim_tpu_torch.engine import make_data, smooth
    from ambersim_tpu_torch.io.bridge import build_model

    m = build_model(skel_fields, leaves, device="cpu")
    qm = smooth.fwd_position_smooth(m, make_data(m, 1)).qM[0].double().numpy()
    return max(float(np.linalg.cond(qm)) * UNIT_ROUNDOFF_F32, 1e-6)


def compare_compiled(name: str, m) -> str:
    """Hold the compiled model `m` against the committed assets/<name>.npz at
    compile_models' bars; returns what it found, fails on a field outside."""
    import numpy as np

    from ambersim_tpu_torch.io.bridge import ASSETS, unpack_npz

    with np.load(ASSETS / f"{name}.npz", allow_pickle=False) as npz:
        want_skel, want = unpack_npz(npz)
    got_skel, got = model_numpy(m)
    if set(got_skel) != set(want_skel) or set(got) != set(want):
        fail(f"compile_models {name}: fields differ: {sorted(set(got_skel) ^ set(want_skel))} "
             f"{sorted(set(got) ^ set(want))}")
    for k, w in want_skel.items():
        if k in MESH_FIELDS:
            continue
        g = got_skel[k]
        same = (isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
                ) if isinstance(w, np.ndarray) else g == w
        if not same:
            fail(f"compile_models {name}: Skeleton field {k} differs from the committed file")
    exact, worst, worst_field = 0, 0.0, None
    for k, w in want.items():
        if k in SETCONST_FIELDS or k in MESH_FIELDS:
            continue
        g = got[k]
        if g.shape != w.shape or (w.dtype.kind != "f" and not np.array_equal(g, w)):
            fail(f"compile_models {name}: leaf {k} differs from the committed file")
        if w.dtype.kind == "f":
            if not np.allclose(g, w, rtol=COMPILE_RTOL, atol=COMPILE_ATOL):
                fail(f"compile_models {name}: leaf {k} off by {np.abs(g - w).max():.3e} "
                     f"(rtol {COMPILE_RTOL}, atol {COMPILE_ATOL})")
            if w.size and np.abs(g - w).max() > worst:
                worst, worst_field = float(np.abs(g - w).max()), k
        exact += int(np.array_equal(g, w))
    rtol = setconst_rtol(got_skel, got)
    rel = 0.0
    for k in SETCONST_FIELDS:
        if got[k].shape != want[k].shape or not np.allclose(got[k], want[k], rtol=rtol, atol=0.0):
            fail(f"compile_models {name}: {k} outside rtol {rtol:.2e} of the committed file")
        if want[k].size:
            rel = max(rel, float((np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1e-30)).max()))
    mesh = "no meshes"
    if int(got_skel["nmesh"]):
        direct = all(got_skel[k].shape == want_skel[k].shape and np.array_equal(got_skel[k], want_skel[k])
                     for k in MESH_FIELDS if k in want_skel)
        direct = direct and all(got[k].shape == want[k].shape and np.allclose(
            got[k], want[k], rtol=COMPILE_RTOL, atol=COMPILE_ATOL) for k in MESH_FIELDS if k in want)
        if direct:
            mesh = "mesh fields in qhull's order of the committed file"
        else:
            for i in range(int(got_skel["nmesh"])):
                for g, w in zip(mesh_canonical(got_skel, got, i), mesh_canonical(want_skel, want, i)):
                    if g.shape != w.shape or not np.allclose(g, w, rtol=COMPILE_RTOL, atol=COMPILE_ATOL):
                        fail(f"compile_models {name}: mesh {i} differs from the committed file beyond qhull's order")
            mesh = "mesh fields equal up to the hull's vertex, face and edge order (qhull ordered them otherwise)"
    n_float = sum(1 for k, w in want.items() if w.dtype.kind == "f" and k not in SETCONST_FIELDS + MESH_FIELDS)
    return (f"{len(want_skel)} Skeleton fields exact; {exact} of {len(want) - 3 - sum(k in want for k in MESH_FIELDS)} "
            f"other leaves bit for bit ({n_float} float), largest float difference {worst:.3e}"
            f"{f' ({worst_field})' if worst_field else ''}; setconst fields within {rel:.3e} relative "
            f"(bar {rtol:.3e}); {mesh}")


def compile_models(device, card: str) -> dict:
    """Compile every committed asset from its MJCF on this machine, through
    the port's loader with the exporter's options, and hold each against the
    committed file (compare_compiled), printing the seconds each took. Then
    the main path from the compiled quadruped: NUM_ENVS x NUM_STEPS PD steps
    from initial_batch with the launch counts set to 0 just before and read
    just after (kernels 1-4, exactly once a step each), held against the
    same rollout of the committed quadruped.npz (the main path's final
    state, SETTLED) within the card-vs-CPU bars.
    Returns the main path's launch counts."""
    import numpy as np
    import scipy
    import torch

    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    print(f"compile_models: numpy {np.__version__}, scipy {scipy.__version__} (qhull's ConvexHull)", flush=True)
    compiled, total = {}, 0.0
    for name in COMPILED_ASSETS:
        t0 = time.perf_counter()
        m = compile_asset(name, device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        total += seconds
        print(f"compile_models: {name} ({COMPILED_ASSETS[name][0]}) compiled onto the card in {seconds:.3f} s "
              f"(nv {m.skel.nv}, nefc {m.skel.nefc}); {compare_compiled(name, m)}", flush=True)
        compiled[name] = m
    print(f"compile_models: {len(compiled)} models in {total:.3f} s", flush=True)

    m, steps = compiled["quadruped"], NUM_STEPS
    d0 = initial_batch(m, NUM_ENVS, device)
    rollout(m, d0, 3, ctrl_fn=pd_ctrl)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    d = rollout(m, d0, steps, ctrl_fn=pd_ctrl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    kernels = _LINALG + ("newton_structured",)
    _check_launches("compile_models quadruped", launches, kernels, steps, {k: steps for k in kernels})
    for field in ("qpos", "qvel", "qacc", "efc_force"):
        if not torch.isfinite(getattr(d, field)).all():
            fail(f"compile_models quadruped: non-finite {field}")
    want = SETTLED["quadruped"]  # the committed quadruped.npz's rollout: the main path's
    dq = (d.qpos - want.qpos).abs().max().item()
    dv = (d.qvel - want.qvel).abs().max().item()
    print(f"compile_models quadruped path from the compiled model: {NUM_ENVS} envs x {steps} steps in "
          f"{seconds:.3f} s = {NUM_ENVS * steps / seconds:.1f} env-steps/s [{card}]; against the committed "
          f"quadruped.npz's rollout on all envs: max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} "
          f"(<= {QVEL_TOL}); launches {launches}", flush=True)
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail("compile_models quadruped: the compiled model's rollout parts from the committed model's")
    return launches


def gripper_model(device):
    """GRIPPER_URDF written to a temporary file and loaded with force_float."""
    import tempfile

    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "gripper.urdf"
        path.write_text(GRIPPER_URDF)
        return load_model_from_file(path, force_float=True, device=device)


def gripper_start(m, batch: int):
    """qpos0 (the free base at the origin, fingers at 0) and a closing ctrl
    per env from U(0.25, 0.75), numpy seed 21 (the first `batch` of
    GRIPPER_ENVS draws)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    ctrl = np.random.default_rng(21).uniform(0.25, 0.75, (GRIPPER_ENVS, 1)).astype(np.float32)[:batch]
    return make_data(m, batch).replace(ctrl=torch.as_tensor(ctrl, device=m.device))


def mimic_residual(m, d):
    """(B,) |q2 - (0.1 + 0.5 q1)|: the gripper's mimic row (finger2 follows
    finger1 with multiplier 0.5 and offset 0.1)."""
    names = list(m.skel.jnt_names)
    q1 = d.qpos[:, int(m.skel.jnt_qposadr[names.index("finger1_joint")])]
    q2 = d.qpos[:, int(m.skel.jnt_qposadr[names.index("finger2_joint")])]
    return (q2 - (0.1 + 0.5 * q1)).abs()


def gripper_urdf(device, card: str) -> dict:
    """The gripper URDF through the port's loader with force_float: its mimic
    joint is one joint equality row (kernel 4 with nd_eq = 1).
    GRIPPER_ENVS x GRIPPER_STEPS steps of gripper_start's closing ctrl with
    the launch counts set to 0 just before and read just after (kernels 1,
    2 and 4 once a step, kernel 3 once a step if the model is damped);
    finite state; the mimic held to MIMIC_TOL in every env; then 8 envs x
    GRIPPER_CPU_STEPS on the card against the CPU. Returns the launches."""
    import torch

    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    m = gripper_model(device)
    s = m.skel
    st = _pyramid_structure(s)
    print(f"gripper_urdf: nq {s.nq}, nv {s.nv}, nu {s.nu}, neq {s.neq} ({list(s.eq_names)}), nefc {s.nefc}, "
          f"nd_eq {st.nd_eq if st else None}, damped {s.has_damping}", flush=True)
    if s.neq != 1 or st is None or st.nd_eq != 1 or s.nq != 9:
        fail("gripper_urdf: the URDF did not compile to a floating base with one joint equality row")
    B, steps = GRIPPER_ENVS, GRIPPER_STEPS
    d0 = gripper_start(m, B)
    rollout(m, d0, 3)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    d = rollout(m, d0, steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    exactly = {"cholesky": steps, "cho_solve": steps, "newton_structured": steps,
               "solve_pd": steps if s.has_damping else 0}
    _check_launches("gripper_urdf", launches, tuple(k for k, n in exactly.items() if n), steps, exactly)
    for field in ("qpos", "qvel", "qacc", "efc_force"):
        if not torch.isfinite(getattr(d, field)).all():
            fail(f"gripper_urdf: non-finite {field}")
    residual = mimic_residual(m, d)
    print(f"gripper_urdf: {B} envs x {steps} steps in {seconds:.3f} s = {B * steps / seconds:.1f} env-steps/s, "
          f"{1e3 * seconds / steps:.3f} ms per step [{card}]; mimic |q2 - (0.1 + 0.5 q1)| max {residual.max().item():.3e} "
          f"(<= {MIMIC_TOL}) median {residual.median().item():.3e}; launches {launches}", flush=True)
    if not residual.max().item() <= MIMIC_TOL:
        fail(f"gripper_urdf: the mimic row is off by {residual.max().item():.3e}")
    SETTLED["gripper_urdf"] = d
    k = GRIPPER_CPU_STEPS
    runs = [rollout(mm, gripper_start(mm, 8), k) for mm in (m, gripper_model("cpu"))]
    dq = (runs[0].qpos.cpu() - runs[1].qpos).abs().max().item()
    dv = (runs[0].qvel.cpu() - runs[1].qvel).abs().max().item()
    print(f"gripper_urdf card vs cpu after {k} steps: max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} "
          f"(<= {QVEL_TOL})", flush=True)
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail("gripper_urdf: card rollout disagrees with the CPU rollout")
    return launches


def grasp_model(device):
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    return load_model_from_file(GRASP_XML, device=device)


def grasp_start(m, batch: int, nudge: float = 0.0):
    """qpos0 with the object's position moved by GRASP_NUDGE N(0, 1) per axis
    (numpy seed 22, the first `batch` of GRASP_BATCHES[0] draws) and every
    qpos by `nudge` more; ctrl GRASP_CTRL."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    move = GRASP_NUDGE * np.random.default_rng(22).standard_normal((GRASP_BATCHES[0], 3)).astype(np.float32)
    qpos = d.qpos.clone()
    qpos[:, 8:11] += torch.as_tensor(move[:batch], device=m.device)
    ctrl = torch.tensor(GRASP_CTRL, device=m.device).expand(batch, -1).contiguous()
    return d.replace(qpos=qpos + nudge, ctrl=ctrl)


def grasp_memory(device) -> int:
    """The grasp scene's collision stage (12 mesh-mesh SAT pairs and 9
    plane-mesh pairs an env) on GRASP_PROBE_ENVS envs at their start: peak
    device memory over the call per env and per mesh-mesh pair; returns the
    largest of GRASP_BATCHES whose peak stays under GRASP_PEAK_GIB."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core.types import GeomType
    from ambersim_tpu_torch.engine import collision, smooth

    m = grasp_model(device)
    s = m.skel
    pairs = sum(1 for t1, t2 in zip(np.asarray(s.pair_ctype1), np.asarray(s.pair_ctype2))
                if t1 == t2 == int(GeomType.MESH))
    P = GRASP_PROBE_ENVS
    d = smooth.fwd_position_smooth(m, grasp_start(m, P))
    collision.collision(m, d)  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = collision.collision(m, d)
    torch.cuda.synchronize()
    per_env = (torch.cuda.max_memory_allocated() - base) / P
    if not torch.isfinite(out.contact.dist).all():
        fail("grasp_memory: non-finite contact distances")
    batch = next((b for b in GRASP_BATCHES if b * per_env < GRASP_PEAK_GIB * 2**30), None)
    print(f"grasp_memory: collision stage on {P} envs (meshes of {np.asarray(s.mesh_vertnum).tolist()} hull vertices, "
          f"{np.asarray(s.mesh_edgenum).tolist()} edges): peak {per_env / 2**20:.2f} MiB an env, "
          f"{per_env / pairs / 2**20:.2f} MiB a mesh-mesh pair ({pairs} an env); batch {batch} "
          f"({batch and batch * per_env / 2**30:.2f} GiB at it, bar {GRASP_PEAK_GIB} GiB)", flush=True)
    if batch is None:
        fail(f"grasp_memory: {per_env / 2**20:.1f} MiB an env leaves no batch of {GRASP_BATCHES} under "
             f"{GRASP_PEAK_GIB} GiB")
    return batch


def grasp_scene(device, card: str, batch: int) -> dict:
    """models/hand/grasp_scene.xml compiled by the port: `batch` envs x
    GRASP_STEPS steps of GRASP_CTRL from grasp_start with the launch counts
    set to 0 just before and read just after (kernels 1-4 exactly once a
    step: the joints are damped). Checks finite state, the object held in
    the palm channel in every env (GRASP_Z); prints env-steps/s, the peak
    device memory and the active contacts per env. Then 8 envs on the card
    against the CPU over GRASP_CPU_STEPS steps by the spread method (10 x the
    card's own spread under a 1e-6 nudge, plus CLUTTER_QPOS_EPS /
    CLUTTER_QVEL_EPS), and their f1 mimic ratio (f1_dist / f1_prox) within
    MIMIC_TOL of the CPU's. Returns the launch counts."""
    import torch

    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    m = grasp_model(device)
    s = m.skel
    first_contact = int(min(s.con_efcadr))
    steps = GRASP_STEPS
    d0 = grasp_start(m, batch)
    rollout(m, d0, 3)  # warm-up
    contacts = torch.zeros((), device=device)

    def count(d):
        contacts.add_(d.efc_active[:, first_contact:].sum())
        return d.ctrl

    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    d = rollout(m, d0, steps, ctrl_fn=count)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kernels = _LINALG + ("newton_structured",)
    _check_launches("grasp_scene", launches, kernels, steps, {k: steps for k in kernels})
    for field in ("qpos", "qvel", "qacc", "efc_force"):
        if not torch.isfinite(getattr(d, field)).all():
            fail(f"grasp_scene: non-finite {field}")
    z = d.qpos[:, 10]
    per_env = (contacts + d.efc_active[:, first_contact:].sum()).item() / 4 / (batch * steps)
    print(f"grasp_scene: {batch} envs x {steps} steps in {seconds:.3f} s = {batch * steps / seconds:.1f} env-steps/s, "
          f"{1e3 * seconds / steps:.3f} ms per step [{card}]; peak device memory over the steps {peak_gib:.2f} GiB "
          f"({peak_gib - held_gib:.2f} GiB above what was held before them); active contacts per env, mean over "
          f"the steps {per_env:.3f} of {s.ncon}; object height in [{z.min().item():.4f}, {z.max().item():.4f}] "
          f"(bar {GRASP_Z}); launches {launches}", flush=True)
    if not bool(((z > GRASP_Z[0]) & (z < GRASP_Z[1])).all()):
        fail("grasp_scene: the object left the palm channel in some env")
    SETTLED["grasp_scene"] = d

    mc, k = grasp_model("cpu"), GRASP_CPU_STEPS
    card_run, nudged, cpu = rollout(m, grasp_start(m, 8), k), rollout(m, grasp_start(m, 8, 1e-6), k), \
        rollout(mc, grasp_start(mc, 8), k)
    spread_q = (card_run.qpos - nudged.qpos).abs().max().item()
    spread_v = (card_run.qvel - nudged.qvel).abs().max().item()
    dq = (card_run.qpos.cpu() - cpu.qpos).abs().max().item()
    dv = (card_run.qvel.cpu() - cpu.qvel).abs().max().item()
    bar_q, bar_v = 10 * spread_q + CLUTTER_QPOS_EPS, 10 * spread_v + CLUTTER_QVEL_EPS
    names = list(s.jnt_names)
    prox, dist = names.index("f1_prox"), names.index("f1_dist")

    def ratio(x):
        return x.qpos[:, dist].cpu() / x.qpos[:, prox].cpu()

    dr = (ratio(card_run) - ratio(cpu)).abs().max().item()
    print(f"grasp_scene card vs cpu, 8 envs x {k} steps: max |dqpos| {dq:.3e} (<= {bar_q:.3e}), max |dqvel| "
          f"{dv:.3e} (<= {bar_v:.3e}); the card's spread under a 1e-6 nudge: {spread_q:.3e} / {spread_v:.3e}; "
          f"f1 mimic ratio card vs cpu max {dr:.3e} (<= {MIMIC_TOL}), card {ratio(card_run).mean().item():.4f}",
          flush=True)
    if not (dq <= bar_q and dv <= bar_v and dr <= MIMIC_TOL):
        fail("grasp_scene: card rollout disagrees with the CPU rollout")
    return launches


def conditioned_within(qM):
    """newton_within with qacc's bar widened, per env, by CONDITIONED_QACC x
    cond(qM) x float32's unit roundoff x max |qacc|: the first-order
    rounding of a solve with qM alone (efc_force and qfrc_constraint keep
    the NEWTON_* bars)."""
    import torch

    widen = CONDITIONED_QACC * torch.linalg.cond(qM.double()) * UNIT_ROUNDOFF_F32

    def within(got: tuple, want: tuple):
        g, w = got[0].double(), want[0].double()
        bar = NEWTON_TOL + NEWTON_TOL * w.abs() + widen[:, None] * w.abs().amax(1, keepdim=True)
        return newton_within(got[1:], want[1:]) & ((g - w).abs() <= bar).all(1)

    return within


def conditioned_factor(got: tuple, want: tuple, qM) -> float:
    """The least CONDITIONED_QACC at which conditioned_within would pass
    every env on qacc: max over envs and components of |got - want| less
    the NEWTON_* bar, over cond(qM) x u x max |want|."""
    import torch

    g, w = got[0].double(), want[0].double()
    over = ((g - w).abs() - NEWTON_TOL - NEWTON_TOL * w.abs()).clamp(min=0.0)
    unit = torch.linalg.cond(qM.double())[:, None] * UNIT_ROUNDOFF_F32 * w.abs().amax(1, keepdim=True)
    return float((over / unit.clamp(min=1e-300)).max().item())


def check_ptxas(log: str) -> None:
    """Print ptxas's registers and spills of every kernel; fail on a spill in
    the kernels that hold their factor's rows in registers (SPILL_FREE)."""
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {name}: {line.strip()}")
        if ("spill" in line and name and any(k in name for k in SPILL_FREE)
                and "0 bytes spill stores, 0 bytes spill loads" not in line):
            fail(f"{name} spills registers: {line.strip()}")


def weighted_launch_time(phase_launches: dict) -> None:
    """Print each kernel's launches by phase and shape (PHASE_SHAPES) with
    launches x (ms - bound) at that shape and the sum over them: the device
    time a redesign of the kernel could win on these runs."""
    weighted = {}
    for phase, launches in phase_launches.items():
        linalg_shape, case = PHASE_SHAPES[phase]
        for k, count in launches.items():
            if not count:
                continue
            shape = case if k.startswith("newton") else linalg_shape
            ms, bound_ms = SHAPE_TIMES[(k, shape)]
            weighted.setdefault(k, []).append(dict(phase=phase, shape=str(shape), launches=count, ms=ms,
                                                   bound_ms=bound_ms, product=count * (ms - bound_ms)))
    for k, rows in weighted.items():
        print(f"kernel {k}: launches x (ms - bound) {sum(r['product'] for r in rows):.2f} = " + " + ".join(
            f"{r['phase']} {r['launches']} x ({r['ms']:.4f} - {r['bound_ms']:.4f}) at {r['shape']}" for r in rows))
    print(json.dumps({"weighted": weighted}))


CAMLIGHT_FIELDS = ("cam_xpos", "cam_xmat", "light_xpos", "light_xdir", "sensordata")


def data_env(d, e: int):
    """Env e of a batch-first Data (its contact set too), as a batch of one."""
    import dataclasses

    import torch

    kw = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v[e:e + 1]
        elif dataclasses.is_dataclass(v):
            kw[f.name] = data_env(v, e)
    return dataclasses.replace(d, **kw)


def quadruped_fluid_checks(device, card: str) -> None:
    """quadruped_fluid's final state: the camera and light frames and the
    four CAMPROJECTION sensors (pixels) within SENSOR_TOL and qfrc_passive
    (springs, dampers, fluid drag, gravity compensation) within
    SENSOR_FORCE_TOL, a forward on the card and on the CPU from the same
    Data (same_input_fields); the feet's pixels finite."""
    m_card, m_cpu = path_model("quadruped_fluid", device), path_model("quadruped_fluid", "cpu")
    s = m_card.skel
    if not (s.has_fluid and s.has_gravcomp and s.ncam == 1 and s.nlight == 1 and s.nsensordata == 8):
        fail("quadruped_fluid: the model lacks its fluid, gravcomp, camera, light or CAMPROJECTION sensors")
    d = SETTLED["quadruped_fluid"]
    if not finite(d.sensordata):
        fail("quadruped_fluid: non-finite CAMPROJECTION pixels")
    same_input_fields("quadruped_fluid", m_card, d, m_cpu, ((CAMLIGHT_FIELDS, SENSOR_TOL),
                                                           (("qfrc_passive",), SENSOR_FORCE_TOL)))
    px = d.sensordata.reshape(-1, 4, 2)
    print(f"quadruped_fluid: feet in the camera at u in [{px[..., 0].min().item():.1f}, {px[..., 0].max().item():.1f}], "
          f"v in [{px[..., 1].min().item():.1f}, {px[..., 1].max().item():.1f}] px (640 x 480) [{card}]", flush=True)


# randomized path -> the bars of an env against its own model
# (quadruped_dr_checks)
DR_CHECKS = {"quadruped_dr": (QPOS_TOL, QVEL_TOL), "quadruped_dr_full": (SAME_QPOS, SAME_QVEL)}


def quadruped_dr_checks(device, card: str, name: str = "quadruped_dr") -> None:
    """8 envs of a randomized path on the card at opt.tolerance 0 (so the
    Newton tolerance's minimum over envs does not enter), DR_CHECK_STEPS
    steps with per-env leaves, each env against a rollout of the unbatched
    model that carries that env's values (core.types.env_slice), within the
    path's DR_CHECKS bars; and the leaves are per env: the model's per-env
    leaves are those its randomization function names, and the envs part."""
    import torch

    from ambersim_tpu_torch.core.types import ENV_LEAVES, env_leaf_names, env_slice
    from ambersim_tpu_torch.engine import rollout

    qpos_tol, qvel_tol = DR_CHECKS[name]
    m, leaves = path_model_leaves(name, device, envs=8)
    m = m.replace(opt=m.opt.replace(tolerance=torch.zeros_like(m.opt.tolerance)))
    if env_leaf_names(m) != tuple(k for k in ENV_LEAVES if k in leaves):
        fail(f"{name}: per-env leaves {env_leaf_names(m)}")
    d0 = initial_batch(m, 8, device)
    batched = rollout(m, d0, DR_CHECK_STEPS, ctrl_fn=pd_ctrl)
    dq = dv = 0.0
    for e in range(8):
        one = rollout(env_slice(m, [e]), data_env(d0, e), DR_CHECK_STEPS, ctrl_fn=pd_ctrl)
        dq = max(dq, (one.qpos - batched.qpos[e:e + 1]).abs().max().item())
        dv = max(dv, (one.qvel - batched.qvel[e:e + 1]).abs().max().item())
    spread = (batched.qpos[:, 2] - batched.qpos[0, 2]).abs().max().item()
    print(f"{name}: 8 envs x {DR_CHECK_STEPS} steps at tolerance 0, each against its own model: max |dqpos| "
          f"{dq:.3e} (<= {qpos_tol}), max |dqvel| {dv:.3e} (<= {qvel_tol}); trunk heights part by up to {spread:.3e} m "
          f"[{card}]", flush=True)
    if not (dq <= qpos_tol and dv <= qvel_tol):
        fail(f"{name}: an env of the batched-leaf rollout parts from its own model's rollout")
    if not spread > 0:
        fail(f"{name}: every env took the same trajectory under per-env leaves")


def ppo_quadruped_dr(device, card: str) -> dict:
    """One PPO training step of the 4096-env locomotion task (ppo_training_step
    at PPO_QUADRUPED) with randomize_quadruped as its randomization_fn: its
    checks, and the eval envs' leaves (64) drawn apart from the training
    envs' (4096). Returns the launch counts."""
    import torch

    from ambersim_tpu_torch.rl.quadruped import randomize_quadruped

    drawn = []

    def randomization_fn(model, generator, num_envs):
        m, names = randomize_quadruped(model, generator, num_envs)
        drawn.append((m, names))
        return m, names

    launches = ppo_training_step("ppo_quadruped_dr", "quadruped_locomotion",
                                 dict(PPO_QUADRUPED, randomization_fn=randomization_fn), device, card)
    c = PPO_QUADRUPED
    if [getattr(m, n[0]).shape[0] for m, n in drawn] != [c["num_envs"], c["num_eval_envs"]]:
        fail(f"ppo_quadruped_dr: randomized batches {[getattr(m, n[0]).shape for m, n in drawn]}")
    (train_m, names), (eval_m, _) = drawn
    same = [k for k in names if torch.equal(getattr(train_m, k)[:c["num_eval_envs"]], getattr(eval_m, k))]
    if same:
        fail(f"ppo_quadruped_dr: the eval envs' {', '.join(same)} repeat the training envs'")
    print(f"ppo_quadruped_dr: per-env {', '.join(names)}; the eval batch's leaves drawn apart from the training "
          f"batch's", flush=True)
    return launches


def run_phases(device, card: str, results: dict) -> None:
    """Phases 3-9: every kernel against its plain version, every path (the
    terrain's among them), model I/O (the port's compiler, a URDF, the mesh
    grasp), trajectory optimization, PPO, gradients through the kernels
    (the Functions, APG, gradient shooting and iLQR), the card against the
    CPU (rollouts, envs and ray), and ES, ARS and SAC; adds each path's
    launches to results. Prints
    each section's wall seconds (how the run's time spreads over its
    sections, host by host) and each phase's within sections 4-9."""
    import torch

    lap = [time.perf_counter(), time.perf_counter()]

    def section(what: str) -> None:
        now = time.perf_counter()
        print(f"chip_smoke: section {what} took {now - lap[0]:.1f} s", flush=True)
        lap[0] = lap[1] = now

    def phase(what: str) -> None:
        """A lap inside a section: the seconds since the section's start or
        the phase before."""
        now = time.perf_counter()
        print(f"chip_smoke: phase {what} took {now - lap[1]:.1f} s", flush=True)
        lap[1] = now

    # the grasp scene's batch, from its mesh-mesh SAT's memory, before the
    # kernels are timed at every phase's shape
    grasp_batch = grasp_memory(device)
    PHASE_SHAPES["grasp_scene"] = ((grasp_batch, 14), "grasp scene")

    # ---- 3. kernels against their plain versions ----
    check_linalg(device, results)
    check_newton(device, results)
    check_newton_hand(device, results)
    check_newton_dense(device, results)
    check_newton_elliptic(device, results)
    check_cho_solve_rhs(device, results)
    torch.cuda.synchronize()
    for row_cap in (False, True):
        try:
            check_selection_exact(device, row_cap)
        except AssertionError as err:
            fail(f"selection with TF32 on (row cap {row_cap}): {err}")
    print("clutter selections with TF32 on: geom ids above 256 and distances exact through the broadphase and "
          "the row cap", flush=True)
    section("3 (kernels against their plain versions)")

    # ---- 4. every path through the port, each with its own launch counts ----
    phase_launches = {}
    for name in PATHS:
        phase_launches[name] = drive_path(name, device, card)
        phase(name)
    # noslip's M^-1 J^T launch of each step, weighed at its own shape
    phase_launches["quadruped_noslip"]["cho_solve"] -= NOSLIP_STEPS
    phase_launches["quadruped_noslip_rhs"] = {"cho_solve": NOSLIP_STEPS}
    check_cg_noslip(device, card)
    phase("check_cg_noslip")

    splits = {}
    for name in ("clutter32_rowcap192", "clutter32_cap48", "clutter32", "clutter32_rowcap192_bf16"):
        splits[name] = stage_split(name, device, card)
    for name in ("clutter32_rowcap192", "clutter32_cap48"):
        clutter_newton_spread(name, device)
    quadruped_sensors_checks(device, card)
    muscle_arm_checks(device, card)
    weld_paths_checks(device, card)
    quadruped_fluid_checks(device, card)
    quadruped_dr_checks(device, card)
    quadruped_dr_checks(device, card, "quadruped_dr_full")
    phase("quadruped_fluid, quadruped_dr and quadruped_dr_full checks")
    print(f"clutter32_rowcap192 solve stage, median ms: bfloat16 Hessian product "
          f"{splits['clutter32_rowcap192_bf16']['solve']:.3f}, float32 {splits['clutter32_rowcap192']['solve']:.3f} "
          f"[{card}]", flush=True)
    section("4 (every path)")

    # ---- 4b. model I/O: the port's compiler on this machine, the main path
    # from a compiled model, a URDF with a mimic joint, the mesh grasp ----
    phase_launches["compile_models"] = compile_models(device, card)
    phase("compile_models")
    phase_launches["gripper_urdf"] = gripper_urdf(device, card)
    phase("gripper_urdf")
    phase_launches["grasp_scene"] = grasp_scene(device, card, grasp_batch)
    section("4b (model I/O)")

    # ---- 5. trajectory optimization on the hand and the humanoid, the hand
    # in contact, and the pendulum at a batch of one ----
    phase_launches["hand_sampling"] = hand_sampling(device, card)
    phase("hand_sampling")
    phase_launches["hand_mesh_sampling"] = hand_mesh_sampling(device, card, results)
    phase("hand_mesh_sampling")
    phase_launches.update(hand_mpc(device, card))
    phase("hand_mpc")
    phase_launches["hand_contacts"] = hand_contacts(device, card)
    phase("hand_contacts")
    phase_launches["humanoid_sampling"] = humanoid_sampling(device, card)
    phase("humanoid_sampling")
    phase_launches["pendulum_single"] = pendulum_single(device, card)
    phase("pendulum_single")
    phase_launches["muscle_arm_sampling"] = muscle_arm_sampling(device, card)
    phase("muscle_arm_sampling")
    check_newton_ladder(device, results)
    check_newton_tendon(device, results)
    check_newton_weld(device, results)
    check_newton_condim(device, results)
    phase("check_newton_ladder, check_newton_tendon, check_newton_weld and check_newton_condim")
    mesh_mesh_memory(device)
    section("5 (trajectory optimization, kernels 4 and 5 on the ladder's, model I/O's, the tendon and the weld paths' "
            "operands)")

    # ---- 6. PPO training through the env layer, each with its own launch counts ----
    phase_launches["ppo_quadruped"] = ppo_training_step("ppo_quadruped", "quadruped_locomotion", PPO_QUADRUPED,
                                                        device, card)
    phase("ppo_quadruped")
    phase_launches["ppo_pendulum"] = ppo_pendulum_learns(device, card)
    phase("ppo_pendulum")
    phase_launches["ppo_humanoid"] = ppo_training_step("ppo_humanoid", "humanoid_balance", PPO_HUMANOID, device, card)
    phase("ppo_humanoid")
    from ambersim_tpu_torch.rl.quadruped import QuadrupedTerrainConfig

    phase_launches["ppo_terrain"] = ppo_training_step("ppo_terrain", "quadruped_terrain", PPO_TERRAIN, device, card,
                                                      dict(config=QuadrupedTerrainConfig(**TERRAIN_CONFIG)))
    phase("ppo_terrain")
    phase_launches["ppo_quadruped_dr"] = ppo_quadruped_dr(device, card)
    phase("ppo_quadruped_dr")
    section("6 (PPO)")

    # ---- 7. gradients through the kernels' Functions, and their users ----
    grad_kernels(device, results)
    phase("grad_kernels")
    phase_launches.update(grad_paths(device, card))
    phase("grad_paths")
    phase_launches["apg_pendulum"] = apg_pendulum(device, card)
    phase("apg_pendulum")
    phase_launches["apg_quadruped"] = apg_quadruped(device, card)
    phase("apg_quadruped")
    phase_launches["ilqr_pendulum"], single_ms = ilqr_pendulum(device, card)
    phase("ilqr_pendulum")
    phase_launches["ilqr_pendulum_batch"] = ilqr_pendulum_batch(device, card, single_ms)
    phase("ilqr_pendulum_batch")
    phase_launches["ilqr_ball"] = ilqr_ball(device, card)
    phase("ilqr_ball")
    phase_launches["hand_gradient_trajopt"] = hand_gradient_trajopt(device, card)
    section("7 (gradients)")

    # ---- 8. card (kernels) against CPU (plain versions), 8 envs x 20 steps ----
    for name in PATHS:
        method = PATHS[name].get("vs_cpu", "start")
        if name == "quadruped_elliptic":
            card_vs_cpu(name, device, QPOS_TOL, QVEL_TOL, opt=CONVERGED)
            card_vs_cpu(name, device, ELLIPTIC_QPOS_TOL, ELLIPTIC_QVEL_TOL)
        elif method == "start":
            card_vs_cpu(name, device, QPOS_TOL, QVEL_TOL)
        elif method == "converged":
            card_vs_cpu(name, device, QPOS_TOL, QVEL_TOL, opt=CONVERGED)
        elif method == "sensors":
            p = PATHS[name]
            sensor_rollout(name, lambda dev: path_model(name, dev), p["start"], 20, device, p["ctrl"])
        elif method != "none":
            settled_card_vs_cpu(device, name)
        phase(f"{name} card vs CPU")
    from ambersim_tpu_torch.rl.humanoid import HumanoidBalanceEnv
    from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv

    # obs columns: gravity, lin_vel, ang_vel, joint pos, 0.1 joint vel, last action
    quad_bars = ((slice(0, 3), QPOS_TOL), (slice(3, 9), QVEL_TOL), (slice(9, 21), QPOS_TOL),
                 (slice(21, 33), 0.1 * QVEL_TOL), (slice(33, 45), 0.0))
    env_card_vs_cpu(device, "quadruped", QuadrupedLocomotionEnv, ENV_CONTROL_STEPS, quad_bars)
    env_card_vs_cpu(device, "quadruped_terrain", terrain_env, ENV_CONTROL_STEPS, quad_bars, reset=terrain_reset)
    # the humanoid's (nq 26, nv 25, nu 19): gravity, lin_vel, ang_vel, height, joint pos, 0.1 joint vel, last action
    env_card_vs_cpu(device, "humanoid_balance", HumanoidBalanceEnv, 5, (
        (slice(0, 3), QPOS_TOL), (slice(3, 9), QVEL_TOL), (slice(9, 29), QPOS_TOL), (slice(29, 48), 0.1 * QVEL_TOL),
        (slice(48, 67), 0.0)))
    phase("env card vs CPU")
    ray_card_vs_cpu(device, card)
    phase("ray card vs CPU")
    sensor_rigs(device)
    phase("sensor rigs card vs CPU")
    tendon_rigs(device)
    phase("tendon rigs card vs CPU")
    weld_rigs(device)
    phase("weld, transmission and pair rigs card vs CPU")
    solver_fixtures(device)
    phase("CG, noslip, FWDINV, inverse and support fixtures card vs CPU")
    section("8 (card against CPU)")

    # ---- 9. ES, ARS and SAC, each with its own launch counts ----
    import numpy as np

    time_linalg_shapes(np.random.default_rng(9), {shape for shape, _ in SECTION9_SHAPES.values()}, device)
    PHASE_SHAPES.update(SECTION9_SHAPES)
    phase_launches.update(gradient_free_and_off_policy(device, card, phase))
    for launches in phase_launches.values():
        for k, n in launches.items():
            results[k]["launches"] += n
    weighted_launch_time(phase_launches)
    section("9 (ES, ARS and SAC)")


def main() -> int:
    t_start = time.perf_counter()
    if not (REPO / "ambersim_tpu_torch").is_dir():
        fail(f"run from a checkout of the repository: no ambersim_tpu_torch/ beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs only on a CUDA card")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ----
    from ambersim_tpu_torch.engine.forward import full_f32_matmul
    from ambersim_tpu_torch.ops import _build

    lib_path, build_s = _build.build()
    print(f"build: {build_s:.1f} s ({lib_path.name})", flush=True)
    check_ptxas(lib_path.with_suffix(".log").read_text())
    _build.library()

    results = {
        k: dict(name=k, route="cuda", source=f"ambersim_tpu_torch/csrc/{src}", replaces=rep, launches=0,
                max_abs_err=None, ms=None, plain_ms=None, bound_ms=None, bound_by=None, library_ms=None,
                backward_ms=None)
        for k, (src, rep) in KERNELS.items()
    }
    with full_f32_matmul():
        run_phases(device, card, results)

    for k, r in results.items():
        missing = [f for f, v in r.items() if v is None and f != "library_ms"]
        if missing or not r["launches"]:
            fail(f"kernel {k}: not measured ({', '.join(missing) or 'no launches on the paths'})")
    print(f"chip_smoke: total wall seconds {time.perf_counter() - t_start:.1f} (build included)")
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
