"""Court dimensions and player-height constants (meters).

A copy of ``padel_analytics_tpu/constants.py``, the reference's
constants/court_dimensions.py and constants/player_heights.py: the port
imports nothing of the JAX package.
"""

# Padel court dimensions (meters).
BASE_LINE = 10
SIDE_LINE = 20
SERVICE_SIDE_LINE = 3
NET_SIDE_LINE = 10

# Professional player heights (meters) — used by the ball-velocity
# estimator for racket-impact height priors.
JUAN_LEBRON = 1.85
ALE_GALAN = 1.86
MARTIN_DINENNO = 1.75
FRANCO_STUPACZUK = 1.80
PAQUITO_NAVARRO = 1.81
FEDE_CHINGOTTO = 1.70
AGUSTIN_TAPIA = 1.79
ARTURO_COELLO = 1.90

AVERAGE_PRO_PLAYER_HEIGHT = (
    JUAN_LEBRON
    + ALE_GALAN
    + MARTIN_DINENNO
    + FRANCO_STUPACZUK
    + PAQUITO_NAVARRO
    + FEDE_CHINGOTTO
    + AGUSTIN_TAPIA
    + ARTURO_COELLO
) / 8
