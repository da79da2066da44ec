"""The port's scaling harness (solr_tpu_torch.bench_scaling) on the
CPU: the host x chip dry run on four gloo ranks (2 hosts x 2 chips), its
ZeRO-1 step held to the same step in one process, and
the rays/s measurement at a small size, on one rank and spread over two
spawned gloo ranks (the path one process takes over several cards)."""

import math

import torch

from solr_tpu_torch import bench_scaling

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)


def test_dryrun_on_four_gloo_ranks():
    rec = bench_scaling._cpu_mesh_dryrun(ranks=4, n_hosts=2)
    assert rec["host_chip_dryrun_ok"], rec
    assert rec["frames_equal"] == [True] * 4
    assert rec["losses_equal"] == rec["params_equal"] == [True] * 4
    assert rec["loss"] > 0.0 and rec["params_moved"] > 0.0
    assert not rec["cuda_touched"]
    assert (rec["devices"], rec["hosts"]) == (4, 2)


def test_measure_one_point_on_cpu():
    rec = bench_scaling._measure(2000, 32, frames=1, device="cpu")
    (point,) = rec["points"]
    assert point["devices"] == 1 and point["label"] == "1 device"
    assert point["launches"] == {}  # the CPU takes the plain versions
    assert math.isfinite(point["rays_per_s"]) and point["rays_per_s"] > 0
    assert rec["process_info"]["process_count"] == 1
    assert rec["device"] == "cpu" and rec["config"].endswith("32^2 2b")


def test_measure_spread_over_two_ranks_on_cpu():
    rec = bench_scaling._measure(2000, 32, frames=1, device="cpu",
                                 local_ranks=2)
    one, two = rec["points"]
    assert two["devices"] == 2 and two["label"] == "1 host"
    assert two["rays_per_s"] > 0
    assert two["efficiency_vs_linear"] == round(
        two["rays_per_s"] / (2 * one["rays_per_s"]), 4)
