"""The readers of the program's spans (spans.py, metrics/idle_ms.*.py,
metrics/image_roofline.py) on synthetic Chrome-trace events."""
import pytest

from port_bench import harness, roofline, spans
from port_bench import trace as TR

NEW = ("idle_ms.chunks", "idle_ms.readback", "idle_ms.film",
       "image_roofline")


def ev(name, cat, start_us, end_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": start_us,
            "dur": end_us - start_us}


def image(t0, length=800.0):
    """One image at t0 (us): a chunk whose launch keeps the card busy
    [t0 + 50, t0 + 250), a wait inside the chunk, then readback and film
    while the card idles, a 10-us copy at t0 + 770 in the image's own
    code. Its idle time: chunks 50 + 50, readback 200, film 250, other
    40 + (length - 800)."""
    host = "user_annotation"
    return [ev("rene.loop.image", host, t0, t0 + length),
            ev("rene.loop.chunk", host, t0, t0 + 300),
            ev("rene.launch.mega_path", host, t0 + 10, t0 + 20),
            ev("rene.loop.wait", host, t0 + 260, t0 + 300),
            ev("rene.loop.readback", host, t0 + 300, t0 + 500),
            ev("rene.loop.film", host, t0 + 500, t0 + 750),
            ev("mega_path_kernel", "kernel", t0 + 50, t0 + 250),
            ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t0 + 770,
               t0 + 780)]


def window(*images_at, lengths=None):
    events = [ev(TR.WINDOW, "user_annotation", 0.0, 10000.0)]
    for i, t0 in enumerate(images_at):
        events += image(t0, (lengths or {}).get(i, 800.0))
    return TR.Trace(events)


def read(name, trace, work=None):
    return harness.load_reader(name)({"trace": trace, "work": work})


def test_an_idle_gap_across_chunk_readback_and_film_is_split_exactly():
    """The card idles from the launch's end at 250 us to the copy at 770
    us: 50 us of the chunk (its wait), 200 of the readback, 250 of the
    film, 20 in the image under none of them; besides, the chunk's first
    50 us and the image's last 20 us."""
    parts = spans.idle_parts(window(100.0))
    assert parts["chunks"] == pytest.approx(100e-6, abs=1e-12)
    assert parts["readback"] == pytest.approx(200e-6, abs=1e-12)
    assert parts["film"] == pytest.approx(250e-6, abs=1e-12)
    assert parts["other"] == pytest.approx(40e-6, abs=1e-12)
    assert parts["images"] == 1


def test_the_parts_add_up_to_the_idle_inside_the_images():
    trace = window(100.0, 2000.0, 5000.0, lengths={1: 1500.0})
    parts = spans.idle_parts(trace)
    # an image's 800 us less its 210 us busy, the second 700 us longer
    assert parts["image"] == pytest.approx(3 * 590e-6 + 700e-6, abs=1e-12)
    assert (parts["chunks"] + parts["readback"] + parts["film"]
            + parts["other"]) == pytest.approx(parts["image"], abs=1e-12)
    assert parts["window"] == pytest.approx(10000e-6 - 3 * 210e-6,
                                            abs=1e-12)
    assert parts["image"] <= parts["window"]


def test_idle_metrics_divide_by_the_image_spans():
    trace = window(100.0, 2000.0, 5000.0)
    assert read("idle_ms.chunks", trace) == pytest.approx(0.100)
    assert read("idle_ms.readback", trace) == pytest.approx(0.200)
    assert read("idle_ms.film", trace) == pytest.approx(0.250)


def test_image_roofline_reads_the_median_image_span(monkeypatch):
    monkeypatch.setattr(roofline, "image_bound_s", lambda work: 1e-4)
    trace = window(100.0, 2000.0, 5000.0, lengths={2: 3000.0})
    # spans of 800, 800 and 3000 us: the median 800
    assert read("image_roofline", trace, work={}) == pytest.approx(12.5)


def test_breakdown_labels_name_the_program_spans():
    """The harness's breakdown puts a whole gap down to the innermost
    span at its middle: the 520-us gap to the film, which the readers
    split."""
    labels = dict(window(100.0).idle_gaps())
    assert labels["host: rene.loop.film"] == pytest.approx(520e-6)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_return_none_untraced_or_without_spans(name):
    assert read(name, None, work={}) is None
    # a program older than the spans: the window and the card's work only
    older = TR.Trace([ev(TR.WINDOW, "user_annotation", 0.0, 1000.0),
                      ev(TR.IMAGE, "user_annotation", 100.0, 900.0),
                      ev("mega_path_kernel", "kernel", 150.0, 350.0)])
    assert read(name, older, work={}) is None
