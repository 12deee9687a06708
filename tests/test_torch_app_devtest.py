"""The port's app on its device source (`kind = devtest`, the run loop
with several runs in flight) against the JAX package's CeracoderApp on
the CPU: identical TS bytes. 96x64 (the pattern's bouncing block needs
a width over 64), runs of 4. The JAX app compiles its generate-and-
encode runs anew for each source it opens, so it runs once here."""

import pytest

import ceracoder_tpu.app.main as j_main
import ceracoder_tpu_torch.app.main as t_main
from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from tests.test_torch_app import H, W, run_app

N_DEV = 8
GOP = 8


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("devtest")
    path = d / "devtest.ini"
    path.write_text(f"[source]\nkind = devtest\nwidth = {W}\nheight = {H}\n"
                    f"fps = 30\n\n[encode]\ncodec = hevc\ngop = {GOP}\n"
                    "run = 4\n")
    return d, str(path)


def test_device_source_run_loop_matches_jax(job):
    d, path = job
    data, _, keys = run_app(t_main, path, d / "port.ts", N_DEV)
    want, _, want_keys = run_app(j_main, path, d / "jax.ts", N_DEV)
    assert data == want
    assert data[::188] == b"\x47" * (len(data) // 188)
    assert keys == want_keys == [True] + [False] * (N_DEV - 1)


def test_app_opens_the_device_source_on_its_device(job):
    from ceracoder_tpu_torch.app.cli import CliOptions

    app = t_main.CeracoderApp(CliOptions(job_file=job[1], addr="x.ts",
                                         port=0), device="cpu")
    assert isinstance(app.source, DeviceTestPatternSource)
    assert app.source.device.type == "cpu"
    assert (app.source.width, app.source.height) == (W, H)
