"""und.shine_ms: the undulator's ray-mode shine, the program's
``sources.shine`` spans (``_SynchrotronBase.shine``: the candidates, the
radiation integral, the resampling and the rays' origins), their device
time summed per pass, mean over the passes whose ``runner.step`` closed
ok."""
from program_records import span_ms


def read(run):
    return span_ms('sources.shine')
