"""Frames already decoded in host memory, as uint8 arrays, with odometry at
the frame rate, handed to observe_odometry / observe_image in a closed loop
(the reference's ProcessBagfile loop)."""


def start(ctx: dict) -> dict:
    frames, stream = ctx["frames"], ctx["stream"]

    def events():
        for kind, t, payload in stream.events(1 << 40):
            yield kind, t, (frames[payload] if kind == "stereo" else payload)

    return dict(calib=ctx["calib"], events=events(), close=lambda: None)
