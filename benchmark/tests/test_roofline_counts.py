"""The roofline's counts come from the cell's inputs and the reference's
walk, so two implementations of one wave count the same work."""
import torch

from benchmark import check, roofline, scenes
from benchmark.reference import walk as ref
from benchmark.tests import sizes
from benchmark import run


def _cfg():
    return run.Cell("wdas_cloud.render", sizes=sizes.RENDER).config


def test_lane_steps_match_the_programs_own_count():
    """The reference's lane-steps of a wave equal the port's plain wave's
    lane-iterations (each lane's steps but a last one that retired it)."""
    from volume_path_tracer_tpu_torch.render import megakernel
    from benchmark import program

    cfg = _cfg()
    W, H = cfg["output_size"]
    dens, _ = scenes.make_volume(cfg["volume"], sizes.SEED, "cpu")
    prog = program.RenderProgram(cfg, dens, None, sizes.SEED, [torch.device("cpu")])
    s = prog.scene
    film = torch.zeros((H, W, 4))
    stream = ref.stream_word(sizes.SEED, 3)
    out = megakernel.render_wave(s.medium, s.params, s.camera, s.bb_table, film, range(W * H), stream,
                                 True, 0.1, return_lane_iters=True)
    vol = check.reference_volume(cfg, dens, None, "cpu", torch.float32)
    c = cfg["camera"]
    cam = ref.Pinhole(c["position"], c["look"], c["up"], c["vfov_deg"], W, H, "cpu")
    pids = torch.arange(W * H)
    streams = torch.full_like(pids, stream)
    o, d = cam.rays(pids, streams)
    res = ref.walk(vol, o, d, pids, streams, cfg["max_iters"])
    retired_by_a_step = int(((res.steps > 0) & ~res.capped).sum())
    assert int(res.steps.sum()) - retired_by_a_step == int(out[2])


def test_work_is_the_same_whole_or_in_halves():
    cfg = _cfg()
    W, H = cfg["output_size"]
    dens, _ = scenes.make_volume(cfg["volume"], sizes.SEED, "cpu")
    pix = list(range(W * H))
    _, _, whole = check.reference_waves(cfg, dens, None, sizes.SEED, [5], [pix], "cpu", measure=True)
    _, _, halves = check.reference_waves(cfg, dens, None, sizes.SEED, [5, 5], [pix[: W * H // 2], pix[W * H // 2:]],
                                         "cpu", measure=True)
    assert whole.lane_steps == halves.lane_steps and whole.corners == halves.corners
    assert whole.pairs == halves.pairs
    b1, b2 = roofline.wave(whole), roofline.wave(halves)
    assert b1 == b2 and b1.binds in ("operations", "bytes")


def test_bound_arithmetic():
    w = roofline.Work(lanes=1000, lane_steps=10_000, corners=100, pairs=10)
    b = roofline.wave(w)
    assert b.ops == 10_000 * 150 + 1000 * 80
    assert b.bytes == 2 * 1000 * 16 + 100 * 32 + 10 * 8
    assert b.seconds == max(b.ops / 67e12, b.bytes / 3.35e12)
    assert roofline.share_percent(b, 2, 4 * b.seconds) == 50.0
    assert roofline.share_percent(b, 0, 1.0) is None
