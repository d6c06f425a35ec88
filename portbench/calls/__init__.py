"""Call kinds: the general generators that a traffic file names.

A traffic file ``traffic/<mix>.json`` holds ``{"call": <kind>, ...}`` and
its parameters; the module ``calls/<kind>.py`` reads them and provides

- ``setup(config, traffic, seed, device) -> state``: makes the inputs from
  the seed, hands them to the program, builds what the traffic needs, and
  warms up every shape the calls use;
- ``call(state) -> out``: one user call, ending where the user has the
  result;
- ``counts(state) -> dict``: the work of one call, for the per-layer
  readers (``metrics/``);
- ``release(state)``: frees the program's state once the window has closed;
- ``judge(state, kept, device) -> [Check]``: the comparison of the kept
  outputs with the plain reference;
- ``control(state, device) -> out``: the reference in the nearest precision
  below the configuration's, put in the program's place (for the readings
  that set the limits; a run never calls it);
- ``KEEP``: how many outputs, drawn from the seed, the comparison keeps.
"""
