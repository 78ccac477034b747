"""Host milliseconds of the `.bt` export (`parallel/multihost.write_bt_sharded`
as `pipelines/rgbd.py` calls it), mean over the untraced jobs."""

SPANS = ["tpu3drec_torch.pipelines.rgbd:write_bt_sharded"]


def read(win):
    s = win.spans.seconds["write_bt_sharded"] if win.spans else []
    return 1e3 * sum(s) / len(s) if s else None
