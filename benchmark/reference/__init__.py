"""The plain reference that decides `correct`: DVG's encoders, decoders,
LSTM, GP, metrics, diverse rollout and three-pass train step in plain
PyTorch, float32 with TF32 off, written from the model's equations. It
imports nothing of the program under test and takes no tensor the program
made: the benchmark hands it the same seeded weights and inputs it hands
the program, and it works out again what the program derives from them
(the BatchNorm fold, the GP cache, the seeded fork noise)."""
