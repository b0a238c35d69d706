"""Device milliseconds of the kernels launched under the port's
`convert.rmvpe` profiler range, per second of audio converted in the traced run's
second window (`harness.Trace`)."""


def read(trace):
    ms, audio_s = trace.range_ms.get("convert.rmvpe"), trace.range_work.get("audio_s")
    if not ms or not audio_s:
        return None
    return ms / audio_s
