"""CLI wiring: every reference subcommand must parse and build its
integrator (examples/cli.rs:147-275). Construction only — rendering is
covered by the integrator suites."""
import pytest

from rustlight_tpu.cli import build_parser, build_integrator

COMMANDS = [
    "ao -d 2.0 -c",
    "direct -b 2 -l 2",
    "path -m 8 -n 1 -r 2 -s bsdf",
    "path -x",
    "light-tracing -m 8 -s volume",
    "vpl -m 6 -n2 64 -b 0.1",
    "vol-primitivies -m 6 -n2 128 -p Beams",
    "vol-primitives -p VRL",
    "plane-single -n2 64 -s cmis",
    "plane-single -s discrete_mis",
    "plane-single -s ualpha",
    "uncorrelated-plane-single -s uv",
    "point-normal -s tr_ex",
    "point-normal -s eq_phase_taylor_ex",
    "point-normal -s pn_tr_taylor_ex",
    "point-normal -s eq_best_ex -k 0.5",
    "point-normal -s pn_warp_ex -w TP -W B",
    "gradient-path -m 6 --strategy-recons weighted",
    "gradient-path-explicit --min-survival 0.5",
    "pssmlt -p 0.4 -b 8192",
    "erpt -k -c 32",
    "smcmc --recons-smcmc naive --init independent",
    "smcmc --init mcmc",
]


@pytest.mark.parametrize("cmd", COMMANDS)
def test_subcommand_builds(cmd):
    args = build_parser().parse_args(
        ["cbox", "-n", "2", "-m", "0.01", "-x", "ats"] + cmd.split())
    integ = build_integrator(args)
    assert integ is not None


class TestGlobalFlags:
    """Reference flag semantics: -t device sharding, -e in ms, -a inf
    (examples/cli.rs:41-51, equal_time.rs:5, avg.rs:21)."""

    def test_threads_builds_mesh_and_renders(self, tmp_path, monkeypatch):
        from rustlight_tpu.cli import main
        out = tmp_path / "t.pfm"
        main(["cbox", "-n", "1", "-s", "0.125", "-t", "8",
              "-o", str(out), "path", "-m", "2"])
        assert out.exists()

    def test_profile_writes_phase_timings(self, tmp_path):
        from rustlight_tpu.cli import main
        import json
        out = tmp_path / "p.pfm"
        prof = tmp_path / "p.json"
        main(["cbox", "-n", "1", "-s", "0.0625", "-o", str(out),
              "--profile", str(prof), "ao"])
        d = json.loads(prof.read_text())
        for k in ("scene_compile_s", "integrator_s", "save_s", "total_s",
                  "n_triangles", "backend", "n_devices"):
            assert k in d, k
        assert d["integrator_s"] > 0 and d["n_triangles"] > 0


class TestDeviceProbe:
    """Device selection: the CLI renders on the platform JAX_PLATFORMS
    names, and a request for a GPU that is not there fails loudly instead
    of rendering on the CPU."""

    def _cli(self, tmp_path, platform):
        import os
        import subprocess
        import sys
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS=platform,
                   RUSTLIGHT_TPU_NO_COMPILE_CACHE="1", PYTHONPATH=repo)
        out = tmp_path / "o.pfm"
        r = subprocess.run(
            [sys.executable, "-m", "rustlight_tpu.cli", "cbox", "-n", "1",
             "-s", "0.03125", "-o", str(out), "ao"],
            cwd=repo, env=env, capture_output=True, text=True, timeout=300)
        return r, out

    def test_gpu_request_without_gpu_fails(self, tmp_path):
        r, out = self._cli(tmp_path, "cuda")
        assert r.returncode != 0
        assert not out.exists()

    def test_cpu_request_renders(self, tmp_path):
        r, out = self._cli(tmp_path, "cpu")
        assert r.returncode == 0, r.stderr[-2000:]
        assert out.exists()

    def test_equal_time_is_milliseconds(self):
        """-e 500 must mean a 0.5 s budget, not 500 s (equal_time.rs:5)."""
        import time
        from rustlight_tpu.models import cornell_box
        from rustlight_tpu.integrators import IntegratorPathTracing
        from rustlight_tpu.integrators.meta import IntegratorEqualTime
        sd = cornell_box(16, 16).compile()
        meta = IntegratorEqualTime(IntegratorPathTracing(max_depth=2,
                                                         hard_cap=2),
                                   target_s=500 / 1e3, spp_per_pass=1)
        t0 = time.time()
        meta.render(sd, seed=0)
        assert time.time() - t0 < 30.0
        assert meta.achieved_spp >= 1

    def test_average_inf_loops_with_dumps(self, tmp_path):
        """-a inf = run forever with per-pass dumps; bounded here via
        max_passes (the CLI's KeyboardInterrupt is the real stop)."""
        from rustlight_tpu.models import cornell_box
        from rustlight_tpu.integrators import IntegratorPathTracing
        from rustlight_tpu.integrators.meta import IntegratorAverage
        sd = cornell_box(16, 16).compile()
        meta = IntegratorAverage(IntegratorPathTracing(max_depth=2,
                                                       hard_cap=2),
                                 spp_per_pass=1,
                                 dump_base=str(tmp_path / "o"), max_passes=3)
        assert meta.infinite
        meta.render(sd, seed=0)
        for i in (1, 2, 3):
            assert (tmp_path / f"o_{i}.pfm").exists()

    def test_average_inf_cli_parses(self):
        args = build_parser().parse_args(["cbox", "-a", "inf", "path"])
        assert args.average == "inf"


def test_average_resume_is_bit_exact(tmp_path):
    """--resume continues -a averaging from the newest dump and reproduces
    the uninterrupted run bit-exactly (pass seeds are seed + pass index)."""
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.integrators.meta import IntegratorAverage
    from rustlight_tpu.utils.image import read_pfm
    import numpy as np
    sd = cornell_box(16, 16).compile()

    def integ():
        return IntegratorPathTracing(max_depth=2, hard_cap=2)

    full = IntegratorAverage(integ(), spp_per_pass=1, nb_passes=4,
                             dump_base=str(tmp_path / "full"))
    full.render(sd, seed=5)

    part = IntegratorAverage(integ(), spp_per_pass=1, nb_passes=2,
                             dump_base=str(tmp_path / "res"))
    part.render(sd, seed=5)
    cont = IntegratorAverage(integ(), spp_per_pass=1, nb_passes=4,
                             dump_base=str(tmp_path / "res"), resume=True)
    film = cont.render(sd, seed=5)

    a = read_pfm(str(tmp_path / "full_4.pfm"))
    b = read_pfm(str(tmp_path / "res_4.pfm"))
    assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(film.buffers["primal"], np.float32), b)
    # no resume target -> fresh run still works
    fresh = IntegratorAverage(integ(), spp_per_pass=1, nb_passes=1,
                              dump_base=str(tmp_path / "none"), resume=True)
    fresh.render(sd, seed=5)
    assert (tmp_path / "none_1.pfm").exists()


def test_smcmc_resume_is_bit_exact(tmp_path):
    """--resume for SMCMC (non-averaging, persistent chains): the chain
    carry is checkpointed atomically alongside each pass dump
    ({dump_base}_state.npz) and reloaded on resume, so the continued run
    reproduces the uninterrupted run bit-exactly (pass streams derive from
    seed + pass index, not carried RNG). Beyond-reference: rustlight keeps
    self.chains only in-process (smcmc.rs:1174-1212), so its crashed -a
    runs lose all chain history."""
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.integrators.mcmc import IntegratorSMCMC
    from rustlight_tpu.integrators.meta import IntegratorAverage
    from rustlight_tpu.utils.image import read_pfm
    import numpy as np
    sd = cornell_box(12, 12).compile()

    def integ():
        return IntegratorSMCMC(
            IntegratorPathTracing(max_depth=2, hard_cap=2),
            recons="naive", keep_chains=True)

    full = IntegratorAverage(integ(), spp_per_pass=8, nb_passes=4,
                             dump_base=str(tmp_path / "full"))
    full.render(sd, seed=5)

    part = IntegratorAverage(integ(), spp_per_pass=8, nb_passes=2,
                             dump_base=str(tmp_path / "res"))
    part.render(sd, seed=5)
    assert (tmp_path / "res_state.npz").exists()
    cont = IntegratorAverage(integ(), spp_per_pass=8, nb_passes=4,
                             dump_base=str(tmp_path / "res"), resume=True)
    film = cont.render(sd, seed=5)

    a = read_pfm(str(tmp_path / "full_4.pfm"))
    b = read_pfm(str(tmp_path / "res_4.pfm"))
    assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(film.buffers["primal"], np.float32), b)
    # without a state dump the old loud-refusal behavior is preserved
    fresh = IntegratorAverage(integ(), spp_per_pass=8, nb_passes=1,
                              dump_base=str(tmp_path / "none"), resume=True)
    fresh.render(sd, seed=5)
    assert (tmp_path / "none_1.pfm").exists()


def test_resume_cli_parses():
    args = build_parser().parse_args(["cbox", "-a", "4", "--resume", "path"])
    assert args.resume and args.average == "4"


def test_aovs_cli_parses():
    args = build_parser().parse_args(["cbox", "--aovs", "gradient-path"])
    assert args.aovs


def test_feature_aovs_cli_parses():
    args = build_parser().parse_args(["cbox", "--feature-aovs", "path"])
    assert args.feature_aovs


def test_adaptive_cli_parses():
    args = build_parser().parse_args(["cbox", "--adaptive", "-n", "16", "path"])
    assert args.adaptive


def test_guiding_cli_parses():
    args = build_parser().parse_args(["cbox", "--guiding", "-n", "16", "path"])
    assert args.guiding


def test_resume_of_completed_run_adds_no_pass(tmp_path):
    """Resuming a run that already reached nb_passes must not render (and
    dump) an extra pass beyond the request."""
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.integrators.meta import IntegratorAverage
    import numpy as np
    sd = cornell_box(12, 12).compile()
    integ = IntegratorPathTracing(max_depth=2, hard_cap=2)
    IntegratorAverage(integ, spp_per_pass=1, nb_passes=2,
                      dump_base=str(tmp_path / "d")).render(sd, seed=1)
    done = IntegratorAverage(integ, spp_per_pass=1, nb_passes=2,
                             dump_base=str(tmp_path / "d"),
                             resume=True).render(sd, seed=1)
    assert not (tmp_path / "d_3.pfm").exists()
    from rustlight_tpu.utils.image import read_pfm
    np.testing.assert_array_equal(
        np.asarray(done.buffers["primal"], np.float32),
        read_pfm(str(tmp_path / "d_2.pfm")))


def test_resume_loads_zero_padded_dump_names(tmp_path):
    """_find_resume must load the file it actually globbed — a zero-padded
    dump name (external tooling) would otherwise resolve to pass k with a
    silently missing film."""
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.integrators.meta import IntegratorAverage
    import numpy as np
    import os
    sd = cornell_box(12, 12).compile()
    integ = IntegratorPathTracing(max_depth=2, hard_cap=2)
    IntegratorAverage(integ, spp_per_pass=1, nb_passes=2,
                      dump_base=str(tmp_path / "z")).render(sd, seed=3)
    os.rename(tmp_path / "z_2.pfm", tmp_path / "z_002.pfm")
    os.remove(tmp_path / "z_1.pfm")
    meta = IntegratorAverage(integ, spp_per_pass=1, nb_passes=3,
                             dump_base=str(tmp_path / "z"), resume=True)
    got = meta._find_resume()
    assert got is not None and got[1] == 2
    assert got[0] is not None          # the film itself was loaded
    meta.render(sd, seed=3)
    assert (tmp_path / "z_3.pfm").exists()


def test_resume_misaligned_state_falls_back_to_film(tmp_path):
    """A state checkpoint whose pass count cannot be aligned with the
    newest dump (stale leftover from a longer run) must be skipped, not
    silently paired with the wrong film."""
    from rustlight_tpu.models import door_box
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.integrators.guiding import IntegratorGuidedPath
    from rustlight_tpu.integrators.meta import IntegratorAverage
    import numpy as np
    import os
    sd = door_box(12, 9).compile()

    def gi():
        return IntegratorGuidedPath(IntegratorPathTracing(max_depth=3), g=8)
    IntegratorAverage(gi(), spp_per_pass=1, nb_passes=3,
                      dump_base=str(tmp_path / "m")).render(sd, seed=2)
    # fake the misalignment: drop all dumps newer than pass 1, keep the
    # pass-3 state -> k=3 > it=1 and no pass-3 film exists
    os.remove(tmp_path / "m_2.pfm")
    os.remove(tmp_path / "m_3.pfm")
    g = gi()
    meta = IntegratorAverage(g, spp_per_pass=1, nb_passes=2,
                             dump_base=str(tmp_path / "m"), resume=True)
    meta.render(sd, seed=2)            # must not crash
    assert (tmp_path / "m_2.pfm").exists()
