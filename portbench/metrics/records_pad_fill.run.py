"""Records: the share of the records source's padded wave matrices that
holds samples, in percent: the samples of their rows (the sum of the true
lengths, ``records.pad_samples``) over their cells (rows times width,
``records.pad_cells``), the program's counts over the window. A program
without the counts gives no value."""

from portbench.program_log import total, window


def read(run):
    log = window(run)
    if log is None:
        return None
    cells = total(log[1], "records.pad_cells")
    return 100.0 * total(log[1], "records.pad_samples") / cells if cells else None
