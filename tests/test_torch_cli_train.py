"""The port's training command lines as a whole, against the JAX
package's, on SyntheticWSSS on the CPU:

  * cli/train_classifier --task predict from the same weights (an orbax
    checkpoint for the JAX CLI, a torch.save one of the same variables
    for the port's, as tests/test_torch_cli_hsn_sec.py does for SEC):
    the calibrated thresholds and the _metrics.csv equal the JAX CLI's;
  * --task train, then --resume: two steps and one resumed step equal
    three steps straight within 1e-6 (one image a batch: the epoch's
    order cannot differ between the two runs, which restart the epoch
    count as the reference does);
  * the exported triplet reads back through the JAX package's
    import_triplet, its .h5 through the JAX package's Keras reader;
  * the chain train_classifier -> gen_cues (with that triplet) ->
    sec_dsrg --task train -> --task predict, each artifact read back
    through the JAX package's readers, and the train log's keys equal
    the JAX CLI's;
  * the SEC/DSRG train task's cue batches, from a pickle and from the
    synthetic fallback, equal the JAX CLI's."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import scipy.io as sio

from test_torch_models import perturbed_variables
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.cli import sec_dsrg as jax_sec_cli
from wsss_tpu.cli import train_classifier as jax_train_cli
from wsss_tpu.eval import reports as jax_reports
from wsss_tpu.io import artifacts as jax_artifacts
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu.io import legacy as jax_legacy
from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu.train.classifier import ClassifierTrainer as JaxTrainer
from wsss_tpu.utils.timing import MetricsLogger as JaxLogger
from wsss_tpu_torch.cli import gen_cues as cues_cli
from wsss_tpu_torch.cli import sec_dsrg as sec_cli
from wsss_tpu_torch.cli import train_classifier as train_cli
from wsss_tpu_torch.io import checkpoint
from wsss_tpu_torch.io.flax_bridge import (classifier_params,
                                           classifier_variables,
                                           load_flax_variables)
from wsss_tpu_torch.models.backbones import build_classifier

SID = 'VOC2012_M7'
SMALL = ['--dataset', 'VOC2012', '--model', 'M7', '--img_size', '32',
         '--synthetic_n', '4', '--batchsize', '2']


def _roots(root):
    return ['--model_root', str(root / 'models'), '--eval_root',
            str(root / 'eval'), '--out_root', str(root / 'out')]


def _metrics_rows(root):
    with open(root / 'eval' / SID / f'{SID}_metrics.csv') as f:
        return list(csv.reader(f))


def _thresholds(root):
    return sio.loadmat(str(root / 'models' / SID / f'{SID}.mat'))[
        'optimalScoreThresh'].reshape(-1)


def test_predict_equals_jax_cli(tmp_path):
    model, variables = perturbed_variables('M7', 20, 32, seed=5)
    state = {'params': variables['params'],
             'model_state': {'batch_stats': variables['batch_stats']},
             'opt_state': JaxTrainer(model).tx.init(variables['params'])}
    jax_ckpt.save_checkpoint(str(tmp_path / 'jax' / 'models' / SID / 'ckpt'),
                             3, state)
    jax_train_cli.main(SMALL + ['--task', 'predict']
                       + _roots(tmp_path / 'jax'))
    net = load_flax_variables(build_classifier('M7', 20), variables)
    checkpoint.save_checkpoint(
        str(tmp_path / 'port' / 'models' / SID / 'ckpt'), 3,
        {'params': net.state_dict()})
    res = train_cli.main(SMALL + ['--task', 'predict', '--device', 'cpu']
                         + _roots(tmp_path / 'port'))
    np.testing.assert_array_equal(_thresholds(tmp_path / 'port'),
                                  _thresholds(tmp_path / 'jax'))
    got, want = (_metrics_rows(tmp_path / r) for r in ('port', 'jax'))
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.array(g[1:], float),
                                   np.array(w[1:], float), atol=1e-6)
    assert np.isfinite(res['mean_f1'])
    # the port's triplet through the JAX package's readers
    template = jax.jit(jax_build('M7', 20).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    arch, params, th = jax_ckpt.import_triplet(
        str(tmp_path / 'port' / 'models' / SID), SID, template['params'])
    assert arch['model'] == 'M7' and arch['num_classes'] == 20
    assert th.shape == (20,)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(variables['params'])):
        np.testing.assert_array_equal(np.asarray(a), b)
    weights = jax_legacy.read_keras_h5(
        str(tmp_path / 'port' / 'models' / SID / f'{SID}.h5'))
    back = jax_legacy.load_keras_weights_into(
        jax.tree_util.tree_map(np.asarray, dict(template)), weights)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _train(root, *extra):
    return train_cli.main(
        ['--dataset', 'VOC2012', '--model', 'M7', '--img_size', '32',
         '--synthetic_n', '1', '--batchsize', '1', '--no_aug',
         '--device', 'cpu'] + _roots(root) + list(extra))


def test_train_then_resume_equals_straight(tmp_path, capsys):
    _train(tmp_path / 'straight', '--epochs', '3')
    _train(tmp_path / 'resumed', '--epochs', '2')
    _train(tmp_path / 'resumed', '--epochs', '1', '--resume')
    assert 'resumed from step 2' in capsys.readouterr().out
    ckpt = os.path.join('models', SID, 'ckpt')
    (a, sa), (b, sb) = (checkpoint.restore_checkpoint(
        str(tmp_path / r / ckpt)) for r in ('straight', 'resumed'))
    assert sa == sb == 3
    for k, v in a['params'].items():
        np.testing.assert_allclose(b['params'][k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    oa, ob = a['opt_state'], b['opt_state']
    assert oa['count'] == ob['count'] == 3
    for i, st in oa['sgd']['state'].items():
        np.testing.assert_allclose(ob['sgd']['state'][i]['momentum_buffer'],
                                   st['momentum_buffer'], rtol=1e-6,
                                   atol=1e-6)


def test_chain_train_cues_sec_train_predict(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cpu = ['--device', 'cpu']
    train_cli.main(SMALL + cpu + _roots(tmp_path))
    triplet = tmp_path / 'models' / SID
    assert {f'{SID}.{e}' for e in ('json', 'npz', 'mat', 'h5')} <= set(
        os.listdir(triplet))
    net = build_classifier('M7', 20)
    _, net, th = checkpoint.import_triplet(str(triplet), SID, net)
    template = jax.jit(jax_build('M7', 20).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    _, params, th_jax = jax_ckpt.import_triplet(str(triplet), SID,
                                                template['params'])
    np.testing.assert_array_equal(th, th_jax)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(classifier_params(net))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert 'batch_stats' in classifier_variables(net)

    cues_cli.main(SMALL + cpu + ['--model_root', str(tmp_path / 'models'),
                                 '--cues_root', str(tmp_path / 'cues')])
    pickle = tmp_path / 'cues' / SID / 'localization_cues.pickle'
    cue_dict = jax_artifacts.read_cue_pickle(str(pickle))
    assert len(cue_dict) == 8
    dense = jax_artifacts.unpack_cues(cue_dict, 0, (41, 41, 21))
    assert dense.sum() > 0

    sec = ['--dataset', 'VOC2012', '--method', 'SEC', '--img_size', '48',
           '--synthetic_n', '4', '--batchsize', '2', '--epochs', '1',
           '--val_every', '1', '--eval_root', str(tmp_path / 'eval'),
           '--out_root', str(tmp_path / 'out'), '--wsss_model_root',
           str(tmp_path / 'wsss')]
    sec_cli.main(sec + cpu + ['--task', 'train', '--cues_pickle',
                              str(pickle)])
    assert 'trained SEC_VOC2012_VGG16 for 2 steps' in capsys.readouterr().out
    rows = JaxLogger(os.path.join('log', 'SEC_VOC2012_VGG16',
                                  'train.jsonl')).read()
    assert [r['step'] for r in rows] == [1, 1, 2, 2]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    res = sec_cli.main(sec + cpu + ['--task', 'predict', '--synthetic_n',
                                    '2'])
    assert 'resumed SEC_VOC2012_VGG16 from step 2' in capsys.readouterr().out
    table = jax_reports.extract_eval(str(tmp_path / 'eval'))
    run = [r for r in table if 'SEC_VOC2012_VGG16' in r['run']]
    assert len(run) == 1
    np.testing.assert_allclose(float(run[0]['miou']), res['miou'],
                               atol=1e-5)

    # the JAX CLI's log of the same run: the same keys on each line
    jax_dir = tmp_path / 'jax'
    jax_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    jax_sec_cli.main(sec + ['--task', 'train', '--cues_pickle', str(pickle),
                            '--wsss_model_root', str(jax_dir / 'wsss')])
    ref_rows = JaxLogger(os.path.join('log', 'SEC_VOC2012_VGG16',
                                      'train.jsonl')).read()
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref_rows]


def test_cue_batches_equal_jax(tmp_path):
    """_batch_cues (a pickle's 41x41 cues nearest-resized to the FCN grid,
    tags with the background set) equals the JAX CLI's, and the synthetic
    fallback equals the JAX CLI's inline code (the same seeded draw)."""
    rng = np.random.default_rng(0)
    cues = {}
    for i in range(3):
        sp = np.stack([rng.integers(0, 21, 30), rng.integers(0, 41, 30),
                       rng.integers(0, 41, 30)])
        cues[f'{i}_cues'] = sp
        cues[f'{i}_labels'] = np.unique(sp[0][sp[0] > 0])
    for grid in (41, 9, 6):
        got = sec_cli._batch_cues(cues, np.array([2, 0]), 21, grid)
        want = jax_sec_cli._batch_cues(cues, np.array([2, 0]), 21, grid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    gt = rng.integers(0, 21, (2, 72, 72)).astype(np.int32)
    step, grid = 5, 9
    cues, labels = sec_cli._synthetic_cues(gt, 21, grid, step)
    # the JAX CLI's fallback, as written in its train loop
    g = jnp.asarray(gt)[..., None].astype(jnp.float32)
    gt_s = np.asarray(jax.image.resize(
        g, (g.shape[0], grid, grid, 1), 'nearest'))[..., 0].astype(np.int64)
    want = np.eye(21, dtype=np.float32)[np.clip(gt_s, 0, 20)]
    want *= (np.random.default_rng(step).random(want.shape[:3] + (1,)) < 0.1)
    want_lab = np.zeros((2, 21), np.float32)
    want_lab[:, 0] = 1
    for i in range(2):
        want_lab[i][np.unique(gt_s[i])] = 1
    np.testing.assert_array_equal(cues, want)
    np.testing.assert_array_equal(labels, want_lab)
