"""Each test leaves the program's tracer as it found it: a reader of the
program's spans turns the tracer on when it is loaded (harness/
program_spans.py), which would otherwise leave it on for the tests that
follow."""
import pytest


@pytest.fixture(autouse=True)
def tracer_as_found():
    try:
        from selfcorr_tpu_torch.utils import tracing
    except ImportError:
        yield
        return
    was = tracing.enabled()
    yield
    (tracing.enable if was else tracing.disable)()
