"""Context: waveforms a second over the files window, the waveforms of every
run finished in it over its whole time (the run in flight at the deadline
completes and counts; the window ends once every save is flushed). It drifts
with the speed of the host's CPU between runs minutes apart, too far for an
end-to-end bound, so it is read here."""


def read(run):
    done, window_s = run.counts.get("waveforms"), run.counts.get("window_s")
    return done / window_s if done and window_s else None
