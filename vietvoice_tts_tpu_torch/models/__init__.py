"""Model definitions: flow-matching DiT, Vocos-style vocoder, ODE sampler,
and the weight-pack → module adapter."""
